"""Two-sided serving tests: the port's ``QueryServer`` and single-node
``launch.serve`` against the reference's, on identical dbs.

Every request goes through ``QueryServer.submit`` on both sides; the rows
each server answers must be identical.  The port runs with
``device="cpu"``; the server runs on its db's device.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.aipm as ref_aipm
import repro.data.synthetic_graph as ref_snb
import repro_torch.core as port_core
import repro_torch.core.aipm as port_aipm
import repro_torch.data.synthetic_graph as port_snb
from repro.serving.engine import QueryServer as RefServer
from repro_torch.serving.engine import QueryServer as PortServer

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

REQUESTS = [
    "MATCH (n:Person)-[:knows]->(m:Person) WHERE n.age < 30 AND "
    "n.photo->face ~: m.photo->face RETURN n.name, m.name",
    "MATCH (n:Person), (m:Person) WHERE n.age < 21 AND n.photo->face ~: "
    "m.photo->face RETURN n.name, m.name LIMIT 25",
    ("MATCH (p:Person) WHERE p.photo->face ~: createFromSource($src)->face "
     "RETURN p.name", "src"),
    "MATCH (n:Person)-[:workFor]->(t:Team) WHERE n.name='person_3' "
    "RETURN t.name",
    "MATCH (n:Person) WHERE n.age > 70 RETURN n.name LIMIT 5",
]


def _db(core, aipm, snb, n=400, cfg=None, **kw):
    db = core.PandaDB(cfg, **kw) if cfg is not None else core.PandaDB(**kw)
    db.register_extractor("face", aipm.feature_hash_extractor(dim=64))
    snb.build_snb(db, snb.SNBConfig(n_persons=n, n_identities=n // 3))
    db.build_index("face", "photo")
    return db


def _photo(db, nid):
    col = db.graph.store.node_props.column("photo")
    return db.graph.blobs.read(int(col.values[nid]))


def _serve(server, db, requests):
    server.start()
    out = []
    try:
        for req in requests:
            params = None
            if isinstance(req, tuple):
                req, _ = req
                params = {"src": _photo(db, 30)}
            rows, err = server.submit(req, params=params).get(timeout=120)
            assert err is None, err
            out.append(rows)
    finally:
        server.close()
    return out


@pytest.fixture(scope="module")
def dbs():
    return (_db(ref_core, ref_aipm, ref_snb),
            _db(port_core, port_aipm, port_snb, device="cpu"))


def test_server_rows_identical(dbs):
    ref, port = dbs
    want = _serve(RefServer(ref, n_workers=2), ref, REQUESTS)
    got = _serve(PortServer(port, n_workers=2), port, REQUESTS)
    assert got == want
    assert all(isinstance(r, list) for r in got) and any(got)


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_each_request_identical(dbs, i):
    ref, port = dbs
    want = _serve(RefServer(ref), ref, [REQUESTS[i]])
    assert _serve(PortServer(port), port, [REQUESTS[i]]) == want


def test_server_counters_match(dbs):
    ref, port = dbs
    rs, ps = RefServer(ref), PortServer(port)
    _serve(rs, ref, REQUESTS[3:])
    _serve(ps, port, REQUESTS[3:])
    assert ps.overload_counters() == rs.overload_counters()
    assert ps.route_counts() == rs.route_counts()


def test_server_needs_a_card_unless_told_cpu(dbs):
    """The server takes its db's device; a db named no device needs a
    card, so a server on the CPU exists only for a db told ``cpu``."""
    _, port = dbs
    assert PortServer(port).device == port.device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_core.PandaDB()


def test_closed_loop_serves_without_failures(dbs):
    _, port = dbs
    server = PortServer(port, n_workers=2)
    stats = server.run_closed_loop(REQUESTS[3:], n_clients=2,
                                   duration_s=0.5)
    assert len(stats.latencies_ms) > 0
    assert server.overload_counters()["failed"] == 0


def test_launch_serve_build_db_identical():
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve
    ref = ref_serve.build_db(60)
    port = port_serve.build_db(60, device="cpu")
    assert port_serve.QUERIES == ref_serve.QUERIES
    for text in port_serve.QUERIES:
        assert port.query(text) == ref.query(text)


def test_traced_serving_identical(dbs):
    """Tracing on changes nothing the server answers, and closes spans."""
    from repro.configs.pandadb import ObsConfig as RefObs
    from repro.configs.pandadb import PandaDBConfig as RefCfg
    from repro_torch.configs.pandadb import ObsConfig as PortObs
    from repro_torch.configs.pandadb import PandaDBConfig as PortCfg
    ref = _db(ref_core, ref_aipm, ref_snb, n=150,
              cfg=dataclasses.replace(RefCfg(), obs=RefObs(trace=True)))
    port = _db(port_core, port_aipm, port_snb, n=150, device="cpu",
               cfg=dataclasses.replace(PortCfg(), obs=PortObs(trace=True)))
    want = _serve(RefServer(ref), ref, REQUESTS[:2])
    assert _serve(PortServer(port), port, REQUESTS[:2]) == want
    assert port.tracer.last is not None
    spans = port.tracer.last.spans()
    names = {s.name for s in spans}
    # the port's vector index adds its own spans under ``index.knn``
    ivf = {"ivf.search", "ivf.probe", "ivf.group", "ivf.gather", "ivf.scan",
           "ivf.fetch", "ivf.map"}
    assert names == {s.name for s in ref.tracer.last.spans()} | ivf
    for s in spans:
        if s.name.startswith("ivf."):
            p = s.parent
            while p is not None and p.name != "index.knn":
                p = p.parent
            assert p is not None, s.name


def test_deadline_overload_counters_identical(dbs):
    """A request whose budget is already spent is dropped by both servers
    the same way."""
    ref, port = dbs
    from repro.configs.pandadb import ServingConfig as RefServing
    from repro_torch.configs.pandadb import ServingConfig as PortServing
    rs = RefServer(ref, serving=RefServing(shed_on_arrival=False))
    ps = PortServer(port, serving=PortServing(shed_on_arrival=False))
    for server in (rs, ps):
        server.start()
        rows, err = server.submit(REQUESTS[4], deadline_ms=1e-6).get(
            timeout=60)
        server.close()
        assert type(err).__name__ == "DeadlineExceeded" and rows == []
    assert ps.overload_counters() == rs.overload_counters()
    assert np.isfinite(ps.overload_counters()["expired"])
