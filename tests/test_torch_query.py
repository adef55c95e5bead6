"""Two-sided query-path tests: the same statements through the reference
``repro`` PandaDB and the port's, built from the same graph and extractors.

Rows must be identical, in order, including ``LIMIT`` prefixes and the
vector-index pushdown (var-var and ``createFromSource`` probes); the
optimizer's plan shapes (``explain()``) must be identical on fresh dbs.
The port runs with ``device="cpu"``; its scan wrappers take their plain
versions.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.aipm as ref_aipm
import repro.data.synthetic_graph as ref_snb
import repro_torch.core as port_core
import repro_torch.core.aipm as port_aipm
import repro_torch.data.synthetic_graph as port_snb
from repro_torch.kernels.ivf_scan import ops as ivf_ops

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)


def _figure1(core, aipm, **db_kw):
    """The paper's Figure-1 graph (as tests/conftest.py builds it)."""
    db = core.PandaDB(**db_kw)
    db.register_extractor("face", aipm.feature_hash_extractor(dim=64))
    db.register_extractor("animal",
                          aipm.label_extractor(["cat", "dog", "bird"]))
    rng = np.random.default_rng(0)
    g = db.graph
    jordan = g.create_node("Person", name="Michael Jordan",
                           photo=rng.bytes(512))
    bulls = g.create_node("Team", name="Chicago Bulls")
    pet = g.create_node("Pet", name="Tom", photo=rng.bytes(512))
    pippen = g.create_node("Person", name="Scott Pippen", photo=rng.bytes(512))
    kerr = g.create_node("Person", name="Steve Kerr", photo=rng.bytes(512))
    warriors = g.create_node("Team", name="Golden State Warriors")
    g.create_relationship(jordan, bulls, "workFor")
    g.create_relationship(jordan, pet, "hasPet")
    g.create_relationship(jordan, pippen, "teamMate")
    g.create_relationship(jordan, kerr, "teamMate")
    g.create_relationship(kerr, warriors, "coachOf")
    return db


def _snb(core, aipm, snb, n=500, index=True, **db_kw):
    db = core.PandaDB(**db_kw)
    db.register_extractor("face", aipm.feature_hash_extractor(dim=64))
    snb.build_snb(db, snb.SNBConfig(n_persons=n, n_identities=n // 3))
    if index:
        db.build_index("face", "photo")
    return db


@pytest.fixture(scope="module")
def figure1_pair():
    return (_figure1(ref_core, ref_aipm),
            _figure1(port_core, port_aipm, device="cpu"))


@pytest.fixture(scope="module")
def snb_pair():
    return (_snb(ref_core, ref_aipm, ref_snb),
            _snb(port_core, port_aipm, port_snb, device="cpu"))


FIGURE1_QUERIES = [
    "MATCH (n:Person)-[:teamMate]->(m:Person) WHERE n.name='Michael Jordan' "
    "RETURN m.name",
    "MATCH (m:Person)<-[:teamMate]-(n:Person) WHERE n.name='Michael Jordan' "
    "RETURN m.name",
    "MATCH (n:Person)-[:teamMate]->(m:Person)-[:coachOf]->(t:Team) "
    "WHERE n.name='Michael Jordan' RETURN m.name, t.name",
    "MATCH (n:Person)-[:hasPet]->(p:Pet) WHERE n.name='Michael Jordan' "
    "AND p.photo->animal='dog' RETURN p.name",
    "MATCH (n:Person) WHERE n.photo->face ~: n.photo->face RETURN n.name",
    "MATCH (n:Person)-[:teamMate]->(m:Person), (c:Person)-[:coachOf]->(t:Team)"
    " WHERE n.name='Michael Jordan' AND t.name='Golden State Warriors' "
    "AND m.photo->face ~: c.photo->face RETURN m.name",
    "MATCH (n:Person), (m:Person) WHERE n.photo->face ~: m.photo->face "
    "RETURN n.name, m.name",
    "MATCH (n:Person) RETURN n.name LIMIT 2",
]


@pytest.mark.parametrize("text", FIGURE1_QUERIES)
def test_figure1_rows_identical(figure1_pair, text):
    ref, port = figure1_pair
    assert port.query(text) == ref.query(text)
    assert port.query(text, optimized=False) == ref.query(text,
                                                          optimized=False)


def test_figure1_with_index_identical():
    ref = _figure1(ref_core, ref_aipm)
    port = _figure1(port_core, port_aipm, device="cpu")
    ref.build_index("face", "photo")
    port.build_index("face", "photo")
    for text in FIGURE1_QUERIES:
        assert port.query(text) == ref.query(text)


def _photo_of(db, person_name):
    nid = db.query(f"MATCH (p:Person) WHERE p.name='{person_name}' "
                   "RETURN p.__self__")[0]["p.__self__"]
    col = db.graph.store.node_props.column("photo")
    return db.graph.blobs.read(int(col.values[nid]))


SNB_QUERIES = [
    "MATCH (n:Person)-[:knows]->(m:Person) WHERE n.photo->face ~: "
    "m.photo->face RETURN n.name, m.name",
    "MATCH (n:Person), (m:Person) WHERE n.age < 22 AND n.photo->face ~: "
    "m.photo->face RETURN n.name, m.name LIMIT 40",
    "MATCH (n:Person)-[:workFor]->(t:Team) WHERE n.name='person_3' "
    "RETURN t.name",
    "MATCH (n:Person) WHERE n.age > 70 RETURN n.name, n.age LIMIT 7",
]


@pytest.mark.parametrize("text", SNB_QUERIES)
def test_snb_rows_identical(snb_pair, text):
    ref, port = snb_pair
    rows = ref.query(text)
    assert port.query(text) == rows


def test_snb_pushdown_runs_the_scan_wrapper(snb_pair):
    """The var-var query reaches the port's ivf_scan wrapper (its plain
    version on the CPU) through search_many, not the Q=1 host path."""
    ref, port = snb_pair
    text = SNB_QUERIES[0]
    idx = port.indexes["face"]
    rows0, launches0 = idx.scan_rows, ivf_ops.launches.n
    assert port.query(text) == ref.query(text)
    assert idx.scan_rows > rows0
    assert ivf_ops.launches.n == launches0   # CPU tensors: nothing launched


def test_snb_create_from_source_probe(snb_pair):
    ref, port = snb_pair
    src = _photo_of(ref, "person_7")
    assert src == _photo_of(port, "person_7")
    text = ("MATCH (p:Person) WHERE p.photo->face ~: "
            "createFromSource($src)->face RETURN p.name")
    rows = ref.query(text, src=src)
    assert rows and {"p.name": "person_7"} in rows
    assert port.query(text, src=src) == rows


@pytest.mark.parametrize("limit", [1, 5, 13])
def test_snb_limit_prefixes(snb_pair, limit):
    ref, port = snb_pair
    text = SNB_QUERIES[0] + f" LIMIT {limit}"
    full = port.query(SNB_QUERIES[0])
    got = port.query(text)
    assert got == ref.query(text)
    assert got == full[:limit]


def test_explain_plan_shapes_identical():
    ref = _snb(ref_core, ref_aipm, ref_snb, n=120)
    port = _snb(port_core, port_aipm, port_snb, n=120, device="cpu")
    for text in SNB_QUERIES + FIGURE1_QUERIES[:3]:
        if "Michael" in text:
            continue
        a, b = ref.explain(text), port.explain(text)
        assert b["optimized"] == a["optimized"]
        assert b["naive"] == a["naive"]


def test_pq_index_pushdown_identical():
    import dataclasses
    from repro.configs.pandadb import PandaDBConfig as RefCfg
    from repro_torch.configs.pandadb import PandaDBConfig as PortCfg
    rc, pc = RefCfg(), PortCfg()
    rc = dataclasses.replace(rc, index=dataclasses.replace(rc.index, pq_m=8))
    pc = dataclasses.replace(pc, index=dataclasses.replace(pc.index, pq_m=8))
    ref = _snb(ref_core, ref_aipm, ref_snb, n=300, cfg=rc)
    port = _snb(port_core, port_aipm, port_snb, n=300, cfg=pc, device="cpu")
    assert port.indexes["face"].pq is not None
    for text in SNB_QUERIES[:2]:
        assert port.query(text) == ref.query(text)


def test_create_statement_identical():
    ref = ref_core.PandaDB()
    port = port_core.PandaDB(device="cpu")
    text = ("CREATE (a:Person {name: 'X'}) CREATE (b:Person {name: 'Y'}) "
            "CREATE (a)-[:knows]->(b)")
    ref.query(text)
    port.query(text)
    q = "MATCH (a:Person)-[:knows]->(b:Person) WHERE a.name='X' RETURN b.name"
    assert port.query(q) == ref.query(q) == [{"b.name": "Y"}]
    assert port.graph.wal.version == ref.graph.wal.version == 1


def test_pandadb_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_core.PandaDB()
    assert port_core.PandaDB(device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.core, repro_torch.serving.engine\n"
            "import repro_torch.launch.serve, repro_torch.data.synthetic_graph\n"
            "import repro_torch.kernels.ivf_scan.ops, "
            "repro_torch.kernels.pq_scan.ops, repro_torch.configs\n"
            "import repro_torch.cluster, repro_torch.kernels.topk_merge.ops\n"
            "import repro_torch.models.transformer, "
            "repro_torch.models.registry, repro_torch.launch.steps\n"
            "import repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.decode_attention.ops\n"
            "import repro_torch.models.moe, repro_torch.distributed, "
            "repro_torch.distributed.collectives\n"
            "import repro_torch.models.gnn.gcn, repro_torch.models.gnn.gat, "
            "repro_torch.models.gnn.gin, repro_torch.models.gnn.graphsage, "
            "repro_torch.models.gnn.schnet, "
            "repro_torch.models.gnn.equiformer, "
            "repro_torch.launch.gnn_steps, repro_torch.data.sampler, "
            "repro_torch.kernels.gather_scatter.ops\n"
            "import repro_torch.models.recsys, "
            "repro_torch.launch.recsys_steps\n"
            "from repro_torch.configs import get_arch, arch_names\n"
            "[get_arch(n) for n in arch_names()]\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr + out.stdout
