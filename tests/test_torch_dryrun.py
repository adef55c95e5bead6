"""Two-sided tests of the port's dry-run tooling (``launch/dryrun.py``,
``launch/perf.py``) against the reference's.

The reference's ``launch/dryrun.py`` and ``launch/perf.py`` set
``XLA_FLAGS`` to 512 host devices when they are imported, which would
change JAX's device count for every later test in this process: their
``model_flops`` and ``VARIANTS`` are read from the source with ``ast``
instead.

* ``model_flops`` of the 40 cells and ``VARIANTS`` equal the reference's.
* Every cell's bundle ``fn`` at a reduced depth runs on ``meta`` tensors,
  and its outputs' shapes and dtypes equal ``jax.eval_shape`` of the
  reference's bundle ``fn``.
* The per-device argument bytes on the 16 x 16 and 2 x 16 x 16 meshes
  equal the reference's, from each leaf's ``NamedSharding.shard_shape``
  on an ``AbstractMesh`` of the same axes, exactly.
* ``run_cell`` on mesh ``one`` and, in a process of its own (it starts a
  fake process group of 256 ranks), on ``single``: the per-device counts,
  collectives and roofline terms; the resumable CLI (each production
  mesh's cells in worker processes of their own) and ``run_variant`` on
  cheap cells.
"""
import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro_torch.configs import all_cells, get_arch
from repro_torch.launch import dryrun, perf, steps
from repro_torch.launch.mesh import HW, ONE

torch.set_num_threads(1)

REF_LAUNCH = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"


def _ref_source_def(path, name):
    """The node of top-level ``name`` in a reference module's source."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return node
    raise KeyError(name)


def test_model_flops_match_reference():
    fn = _ref_source_def(REF_LAUNCH / "dryrun.py", "model_flops")
    ns = {"get_arch": ref_get_arch}
    exec(compile(ast.Module([fn], []), "model_flops", "exec"), ns)
    for arch, shape in all_cells():
        assert dryrun.model_flops(arch, shape) == ns["model_flops"](
            arch, shape), (arch, shape)


def test_variants_match_reference():
    node = _ref_source_def(REF_LAUNCH / "perf.py", "VARIANTS")
    assert perf.VARIANTS == ast.literal_eval(node.value)


def _reduced(arch):
    """Depth cuts that keep every code path: two LM layers (a MoE config
    keeps its dense first layer), one Equiformer layer."""
    spec = get_arch(arch)
    if spec.family == "lm":
        return {"n_layers": 2}
    if spec.model.kind == "equiformer_v2":
        return {"n_layers": 1}
    return None


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", list(dict.fromkeys(a for a, _ in
                                                    all_cells())))
def test_bundle_fns_run_on_meta_with_the_reference_output_shapes(arch):
    mesh = ref_smoke_mesh()
    for a, shape in all_cells():
        if a != arch:
            continue
        over = _reduced(arch)
        got = steps.build_step(arch, shape, ONE, cfg_overrides=over)
        ref = ref_steps.build_step(arch, shape, mesh, cfg_overrides=over)
        with jax.set_mesh(mesh):
            want = jax.eval_shape(ref.fn, *ref.abstract_args)
        out = got.fn(*got.abstract_args)
        kind = got.meta["kind"]
        if kind.endswith("train"):
            # (parameters, opt_state, metrics): the reference's trees
            # hold the same leaves; compare them as multisets of shapes
            # and the metrics by name
            params, opt, met = out
            assert all(t.is_meta for t in params.values())
            assert sorted(_shapes(list(params.values()))) == sorted(
                _stacked_shapes(want[0], arch)), shape
            assert sorted(_shapes([opt["m"], opt["v"], opt["step"]])) == \
                sorted(_stacked_shapes((want[1]["m"], want[1]["v"],
                                        want[1]["step"]), arch)), shape
            assert {k: _shapes(v)[0] for k, v in met.items()} == {
                k: _shapes(v)[0] for k, v in want[2].items()}, shape
        else:
            assert _shapes(out) == _shapes(want), shape


def _stacked_shapes(tree, arch):
    """Leaf shapes of a reference param tree as the port holds them:
    SchNet's and Equiformer's stacked groups as one leaf a layer."""
    kind = getattr(get_arch(arch).model, "kind", None)
    group = {"schnet": "interactions", "equiformer_v2": "layers"}.get(kind)
    out = []
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", None) for k in path]
        if group is not None and group in keys:
            out += [(tuple(x.shape[1:]), str(x.dtype))] * x.shape[0]
        else:
            out.append((tuple(x.shape), str(x.dtype)))
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_arg_bytes_per_device_match_reference(mesh):
    port_mesh = dryrun.MESHES[mesh]()
    ref_mesh = AbstractMesh(tuple(port_mesh.shape.values()),
                            port_mesh.axis_names)
    for arch, shape in all_cells():
        got = dryrun.arg_bytes_per_device(
            steps.build_step(arch, shape, port_mesh), port_mesh)
        ref = ref_steps.build_step(arch, shape, ref_mesh)
        want = sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                   for x, s in zip(jax.tree.leaves(ref.abstract_args),
                                   jax.tree.leaves(ref.in_shardings)))
        assert got == want, (arch, shape)


def test_run_cell_one_and_single():
    one = dryrun.run_cell("gcn-cora", "full_graph_sm", "one")
    assert one["n_chips"] == 1 and one["kind"] == "gnn_train"
    an, r = one["analysis"], one["roofline"]
    assert an["kernels"]["gather_scatter"]["calls"] == 4     # 2 layers
    assert r["compute_s"] == an["flops"] / HW["peak_flops_fp32"]
    assert r["memory_s"] == an["bytes_accessed"] / HW["hbm_bw"]
    assert r["collective_s"] == 0 and one["collectives"] == {}
    assert one["fits_80GB"] and one["peak_bytes"] >= \
        one["arg_bytes_per_device"]
    # the production mesh starts a fake process group: a process of its own
    code = ("import json\n"
            "from repro_torch.launch import dryrun\n"
            "print(json.dumps(dryrun.run_cell('gcn-cora', 'full_graph_sm',"
            " 'single')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REF_LAUNCH.parents[2],
                         env=dict(os.environ, PYTHONPATH=str(
                             REF_LAUNCH.parents[1])))
    assert out.returncode == 0, out.stderr[-3000:]
    single = json.loads(out.stdout.strip().splitlines()[-1])
    assert single["n_chips"] == 256 and "even_split" not in single
    assert single["flops"] == single["analysis"]["flops"] > 0
    assert single["bytes"] == single["analysis"]["bytes_accessed"]
    assert single["collectives"]["all-reduce"]["count"] > 0
    assert single["collective_bytes"] == pytest.approx(sum(
        e["bytes"] for e in single["collectives"].values()))
    sr = single["roofline"]
    assert sr["collective_s"] == pytest.approx(
        single["collective_bytes"] / HW["link_bw"])
    assert sr["dominant"] == max(("compute", "memory", "collective"),
                                 key=lambda k: sr[f"{k}_s"])
    assert single["fits_80GB"] == (single["peak_bytes"] <= HW["hbm_bytes"])
    # edges shard over data: a device gathers a sixteenth of them
    assert an["kernels"]["gather_scatter"]["bytes"] > \
        single["analysis"]["kernels"]["gather_scatter"]["bytes"]
    lm = dryrun.run_cell("llama3-8b", "long_500k", "one")
    assert lm["roofline"]["peak_flops"] == HW["peak_flops_bf16"]
    assert lm["useful_flops_ratio"] == pytest.approx(
        dryrun.model_flops("llama3-8b", "long_500k") / lm["analysis"]
        ["flops"])


def test_cli_writes_one_json_per_cell_and_resumes(tmp_path, capsys):
    argv = ["--arch", "autoint", "--shape", "serve_p99", "--mesh", "all",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"autoint__serve_p99__{m}.json"
                     for m in ("multi", "one", "single")]
    res = json.loads((tmp_path / names[1]).read_text())
    assert res["analysis"]["kernels"]["gather_scatter"]["calls"] == 1
    assert dryrun.main(argv) == 0
    assert "ok=0 fail=0 skip=3" in capsys.readouterr().out


def test_run_variant_writes_its_result(tmp_path):
    res = perf.run_variant("autoint", "retrieval_cand", "bf16_cands",
                           out_dir=str(tmp_path))
    assert res["dominant"] in ("compute", "memory")
    assert set(res["kernels"]) == {"gather_scatter", "ivf_scan"}
    assert (tmp_path / "autoint__retrieval_cand__bf16_cands.json").exists()
    assert perf.main(["--list"]) == 0
