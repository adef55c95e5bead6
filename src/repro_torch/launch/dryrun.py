"""Dry run: every (arch x shape) cell's step counted on the ``meta`` device,
the reference's ``launch/dryrun.py``.

No card and no compile: each cell's ``StepBundle`` (``launch/steps.py``)
runs once on meta tensors under ``launch/op_analysis.py``, at full size, on
any host.  For mesh ``one`` (one card) a cell reports its FLOPs, bytes,
peak bytes and the roofline terms against the H100's peaks
(``launch/mesh.py::HW``); for the production meshes (``single``, 16 x 16;
``multi``, 2 x 16 x 16) the exact argument bytes a device holds under the
cell's sharding rules, and the one-card count split evenly over the chips.
Collectives are not counted on more than one rank: the models do not run
on DTensors over a fake process group yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh one
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all \\
      --jobs 4 --out results/dryrun_torch
Results are one JSON per cell and mesh; existing files are skipped
(resumable).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.configs import all_cells, get_arch
from repro_torch.distributed.sharding import mesh_axes
from repro_torch.launch.mesh import (HW, ONE, make_production_mesh,
                                     mesh_size, peak_flops)
from repro_torch.launch.op_analysis import analyze, roofline
from repro_torch.launch.steps import StepBundle, build_step, flat_leaves

MESHES = {"one": lambda: ONE,
          "single": lambda: make_production_mesh(),
          "multi": lambda: make_production_mesh(multi_pod=True)}

COLLECTIVES_NOTE = ("not counted: the models do not run on DTensors over a "
                    "fake process group yet (ROADMAP Queue A)")


def model_flops_of(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) for training, 2 N
    D for prefill, 2 N a sequence for decode; 0 for a model that is not
    an LM."""
    if not hasattr(cfg, "is_moe"):
        return 0.0
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS of a cell (the reference's ``model_flops``)."""
    spec = get_arch(arch)
    if spec.family != "lm":
        return 0.0
    return model_flops_of(spec.model, spec.shape(shape_name))


def shard_bytes(t: torch.Tensor, spec: Tuple, axes: Dict[str, int]) -> int:
    """Bytes of the largest shard of ``t`` under partition ``spec`` on a
    mesh of these axis sizes: each dim divided, rounded up, by the product
    of the axes its entry names."""
    n = t.element_size()
    for i, dim in enumerate(t.shape):
        phys = spec[i] if i < len(spec) else None
        names = () if phys is None else (phys,) if isinstance(phys, str) \
            else phys
        n *= -(-dim // math.prod(axes.get(a, 1) for a in names))
    return n


def arg_bytes_per_device(bundle: StepBundle, mesh: Any) -> int:
    """The bytes of the step's arguments one device holds (exact, from
    each leaf's spec)."""
    axes = mesh_axes(mesh)
    return sum(shard_bytes(t, spec, axes) for t, spec in flat_leaves(
        bundle.abstract_args, bundle.in_specs).values())


def run_cell(arch: str, shape_name: str, mesh: str = "one"
             ) -> Dict[str, Any]:
    """One cell on mesh ``one``, ``single`` or ``multi``: its bundle built
    for that mesh, counted once on meta (see the module docstring)."""
    m = MESHES[mesh]()
    n_chips = mesh_size(m)
    t0 = time.perf_counter()
    bundle = build_step(arch, shape_name, m)
    an = analyze(bundle.fn, *bundle.abstract_args)
    spec = get_arch(arch)
    peak = peak_flops(getattr(spec.model, "dtype", "float32"))
    mflops = model_flops(arch, shape_name)
    args_dev = arg_bytes_per_device(bundle, m)
    args_all = arg_bytes_per_device(bundle, ONE)
    temps = max(an.peak_bytes - args_all, 0.0)
    res: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "n_chips": n_chips,
        "kind": bundle.meta.get("kind"),
        "arg_bytes_per_device": args_dev,
        "model_flops_total": mflops,
        "useful_flops_ratio": mflops / an.flops if an.flops else None,
    }
    if n_chips == 1:
        r = roofline(an, peak)
        res.update(
            analysis=an.as_dict(), peak_bytes=an.peak_bytes,
            fits_80GB=an.peak_bytes <= HW["hbm_bytes"],
            roofline=dict(r, peak_flops=peak))
    else:
        split = dict(flops_per_chip=an.flops / n_chips,
                     bytes_per_chip=an.bytes_accessed / n_chips,
                     temp_bytes_per_chip=temps / n_chips)
        split.update(compute_s=split["flops_per_chip"] / peak,
                     memory_s=split["bytes_per_chip"] / HW["hbm_bw"],
                     peak_flops=peak)
        res.update(
            even_split=split, flops_total=an.flops,
            fits_80GB=args_dev + split["temp_bytes_per_chip"]
            <= HW["hbm_bytes"],
            fits_basis="arguments per device plus the one-card "
                       "temporaries split evenly",
            collectives=None, collectives_note=COLLECTIVES_NOTE)
    res["seconds"] = time.perf_counter() - t0
    return res


def _run_one(job: Tuple[str, str, str]) -> Dict[str, Any]:
    """A pool worker's cell: its result, or the error it raised."""
    torch.set_num_threads(1)
    arch, shape, mesh = job
    try:
        return run_cell(arch, shape, mesh)
    except Exception as e:  # noqa: BLE001 -- reported as the cell's result
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def run_cells(jobs: Iterable[Tuple[str, str, str]], n_proc: int = 1
              ) -> Iterable[Dict[str, Any]]:
    """Each (arch, shape, mesh) job's result (or its ``error``), in order;
    ``n_proc`` > 1 spreads them over that many worker processes, which end
    with the call."""
    jobs = list(jobs)
    if n_proc <= 1:
        for job in jobs:
            yield _run_one(job)
        return
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(n_proc) as pool:
        yield from pool.imap(_run_one, jobs)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["one", "single", "multi", "all"],
                    default="one")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each cell runs in one)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    todo, n_skip = [], 0
    for arch, shape in cells:
        for mesh in meshes:
            if (out_dir / f"{arch}__{shape}__{mesh}.json").exists() \
                    and not args.force:
                n_skip += 1
            else:
                todo.append((arch, shape, mesh))
    n_ok = n_fail = 0
    for res in run_cells(todo, args.jobs):
        tag = f"{res['arch']}__{res['shape']}__{res['mesh']}"
        if "error" in res:
            n_fail += 1
            (out_dir / f"{tag}.FAILED.json").write_text(
                json.dumps(res, indent=1))
            print(f"[dryrun] {tag} FAILED: {res['error'][:200]}", flush=True)
            continue
        n_ok += 1
        (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
        one = res["n_chips"] == 1
        terms = res["roofline"] if one else res["even_split"]
        flops = res["analysis"]["flops"] if one else res["flops_total"]
        print(f"[dryrun] {tag} {res['seconds']:.1f}s flops={flops:.4g} "
              f"compute_s={terms['compute_s']:.4g} "
              f"memory_s={terms['memory_s']:.4g} args_per_device_GB="
              f"{res['arg_bytes_per_device'] / 1e9:.3f} "
              f"fits_80GB={res['fits_80GB']}", flush=True)
    print(f"[dryrun] done ok={n_ok} fail={n_fail} skip={n_skip}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
