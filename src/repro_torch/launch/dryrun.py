"""Dry run: every (arch x shape) cell's step counted for one device on the
``meta`` device, the reference's ``launch/dryrun.py``.

No card and no compile: each cell's ``StepBundle`` (``launch/steps.py``)
runs once on meta tensors under ``launch/op_analysis.py``, at full size, on
any host.  Mesh ``one`` is one card.  On the production meshes (``single``,
16 x 16; ``multi``, 2 x 16 x 16) the step runs on DTensors over a fake
process group of 256 or 512 ranks (``launch/mesh.py::make_fake_mesh``):
each argument is placed by the cell's sharding rules
(``distributed/sharding.py::place_tree``), the models constrain their
activations at the reference's points, and the count is that of rank 0:
its local FLOPs and bytes, its peak of live local bytes, and every
collective that DTensor or a kernel wrapper runs, by kind, with its count
and bytes.  Each cell reports what the reference's reports, per device:
``flops``, ``bytes``, ``peak_bytes``, ``collectives``, ``collective_bytes``,
the roofline's ``compute_s``, ``memory_s`` and ``collective_s`` (against
``launch/mesh.py::HW``) and the ``dominant`` one, ``model_flops_total``
and ``useful_flops_ratio`` = model FLOPs / (per-device FLOPs x chips), and
``fits_80GB`` from the device's own peak.

A process holds one default process group, and a fake group of 256 ranks
and one of 512 cannot live in one process: ``run_cells`` runs the cells of
each production mesh in worker processes of their own (``spawn``), each
holding that mesh's group; mesh ``one`` runs where it is called.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all \\
      --jobs 4 --out results/dryrun_torch
Results are one JSON per cell and mesh; existing files are skipped
(resumable).
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.configs import all_cells, get_arch
from repro_torch.distributed.sharding import mesh_axes, place_tree
from repro_torch.launch.mesh import (HW, ONE, make_fake_mesh,
                                     make_production_mesh, mesh_size,
                                     peak_flops)
from repro_torch.launch.op_analysis import analyze, roofline
from repro_torch.launch.steps import StepBundle, build_step, flat_leaves

#: the meshes' axes (stand-ins: the rules read only names and sizes)
MESHES = {"one": lambda: ONE,
          "single": lambda: make_production_mesh(),
          "multi": lambda: make_production_mesh(multi_pod=True)}

#: this process's fake-group mesh, by mesh name
_FAKE: Dict[str, Any] = {}


def fake_mesh(mesh: str):
    """The ``DeviceMesh`` of production mesh ``mesh`` over this process's
    fake group, made on first use (a process holds one)."""
    if mesh not in _FAKE:
        if _FAKE:
            raise RuntimeError(f"dryrun: this process holds mesh "
                               f"{next(iter(_FAKE))!r}, not {mesh!r}")
        m = MESHES[mesh]()
        _FAKE[mesh] = make_fake_mesh(tuple(m.shape.values()), m.axis_names)
        # DTensor warns at every nested redistribution; the count sees them
        logging.getLogger("torch.distributed.tensor").setLevel(
            logging.ERROR)
    return _FAKE[mesh]


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
    for that mesh and counted once on meta, for one device (the module
    docstring).  ``single`` and ``multi`` start this process's fake group
    (:func:`fake_mesh`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    stand_in = MESHES[mesh]()
    n_chips = mesh_size(stand_in)
    t0 = time.perf_counter()
    if n_chips == 1:
        bundle = build_step(arch, shape_name, stand_in)
        an = analyze(bundle.fn, *bundle.abstract_args)
    else:
        dm = fake_mesh(mesh)
        bundle = build_step(arch, shape_name, dm)
        args = tuple(place_tree(a, s, dm) for a, s in
                     zip(bundle.abstract_args, bundle.in_specs))
        # the plain tensors a step makes (positions, masks) are the same
        # on every rank: replicated
        with implicit_replication():
            an = analyze(bundle.fn, *args)
    spec = get_arch(arch)
    peak = peak_flops(getattr(spec.model, "dtype", "float32"))
    mflops = model_flops(arch, shape_name)
    r = roofline(an, peak)
    res: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "n_chips": n_chips,
        "kind": bundle.meta.get("kind"),
        "flops": an.flops, "bytes": an.bytes_accessed,
        "peak_bytes": an.peak_bytes, "collectives": an.collectives,
        "collective_bytes": an.collective_bytes,
        "top_collectives": an.top_collectives(),
        "roofline": dict(r, peak_flops=peak),
        "model_flops_total": mflops,
        "useful_flops_ratio": mflops / (an.flops * n_chips)
        if an.flops else None,
        "arg_bytes_per_device": arg_bytes_per_device(bundle, stand_in),
        "fits_80GB": an.peak_bytes <= HW["hbm_bytes"],
        "analysis": an.as_dict(),
    }
    res["seconds"] = time.perf_counter() - t0
    return res


def _run_one(job: Tuple[str, str, str]) -> Dict[str, Any]:
    """A cell's result, or the error it raised."""
    arch, shape, mesh = job
    try:
        return run_cell(arch, shape, mesh)
    except Exception as e:  # noqa: BLE001 -- reported as the cell's result
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def _init_worker(mesh: str) -> None:
    torch.set_num_threads(1)
    if mesh != "one":
        fake_mesh(mesh)


def run_cells(jobs: Iterable[Tuple[str, str, str]], n_proc: int = 1
              ) -> Iterable[Dict[str, Any]]:
    """Each (arch, shape, mesh) job's result (or its ``error``), mesh by
    mesh in the order the meshes first appear, each mesh's in order.  Mesh
    ``one`` runs here when ``n_proc`` <= 1; every other mesh, and mesh
    ``one`` when ``n_proc`` > 1, in a pool of up to ``n_proc`` worker
    processes holding that mesh (``spawn``), which end with its jobs."""
    import multiprocessing as mp

    by_mesh: Dict[str, List[Tuple[str, str, str]]] = {}
    for job in jobs:
        by_mesh.setdefault(job[2], []).append(job)
    for mesh, group in by_mesh.items():
        if mesh == "one" and n_proc <= 1:
            torch.set_num_threads(1)
            for job in group:
                yield _run_one(job)
            continue
        n = max(1, min(n_proc, len(group)))
        with mp.get_context("spawn").Pool(
                n, initializer=_init_worker, initargs=(mesh,)) as pool:
            yield from pool.imap(_run_one, group)


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
        r = res["roofline"]
        print(f"[dryrun] {tag} {res['seconds']:.1f}s flops={res['flops']:.4g}"
              f" bytes={res['bytes']:.4g} peak_GB="
              f"{res['peak_bytes'] / 1e9:.3f} collective_GB="
              f"{res['collective_bytes'] / 1e9:.4g} compute_s="
              f"{r['compute_s']:.4g} memory_s={r['memory_s']:.4g} "
              f"collective_s={r['collective_s']:.4g} "
              f"dominant={r['dominant']} fits_80GB={res['fits_80GB']}",
              flush=True)
    print(f"[dryrun] done ok={n_ok} fail={n_fail} skip={n_skip}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
