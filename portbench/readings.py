"""The readings the comparison's limits are set from, for one cell, in one
process (the benchmark's own runs never run this).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 2 [--out file.jsonl]

For each seed of ``--seeds``: a run of the program with a short window
(``run.run_cell``), its numbers.  For each seed of ``--control-seeds``, at
the cell's own size, with the same inputs and as many batches as a run
compares, the reference put in the program's place:

* ``float32``: in the program's own precision (a second witness);
* ``tf32``: the control, every product's operands rounded to TF32;
* the faults, planted in the float32 one: ``state_unchanged`` (k-means'
  refinements skipped: the cores as drawn), ``half_batch`` (the second
  half of each batch's queries left unanswered), ``answer_altered`` (one
  answer of each batch names another row), ``answers_swapped`` (each
  query's first two answers swapped).

Each line printed is one JSON object: the seed, who, the numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, data, reference, run  # noqa: E402


def _numbers(rows, queries, cfg, seed, state, answers, k, nprobe, dev):
    out = check.build_numbers(rows, cfg["index"], seed, state, dev)
    out.update(check.search_numbers(rows, queries, answers, state,
                                    cfg["index"]["metric"], k, nprobe, dev))
    return out


def in_place(rows, queries, cfg, seed, precision, batches, k, nprobe, dev,
             iters=-1):
    """(index state, answers) of the reference in the program's place."""
    x = torch.from_numpy(rows).to(dev)
    km = reference.kmeans(x, cfg["index"], seed, precision, iters=iters)
    ids, bucket_of = reference.layout(km["bucket"])
    state = {"centroids": km["centroids"].float().cpu().numpy(),
             "bucket_of": bucket_of.cpu().numpy(),
             "ids": ids.cpu().numpy()}
    answers = []
    for qi in batches:
        q = torch.from_numpy(queries[qi]).to(dev)
        answers.append((qi, *reference.search(
            km["centroids"], km["bucket"], x, q, k, nprobe,
            cfg["index"]["metric"], precision)))
    return state, answers


def control_readings(workload, seed, dev, bench_dir=HERE, root=HERE.parent):
    """{who: numbers} of the reference in place, the control and the
    faults for one seed at the cell's size."""
    spec = run.cell_spec(workload, root, bench_dir)
    cfg, tr = spec["config"], spec["traffic"]
    k, nprobe = int(tr["k"]), int(tr["nprobe"])
    rows, queries = data.make_vectors(cfg["vectors"], int(cfg["n_queries"]),
                                      seed, dev)
    draws = data.batch_draws(seed, len(queries), int(tr["batch"]))
    batches = [next(draws) for _ in range(int(tr["check_batches"]))]
    out = {}

    def judge(who, state, answers):
        out[who] = _numbers(rows, queries, cfg, seed, state, answers, k,
                            nprobe, dev)

    for precision in ("float32", "tf32"):
        state, answers = in_place(rows, queries, cfg, seed, precision,
                                  batches, k, nprobe, dev)
        judge(precision, state, answers)
        if precision == "float32":
            good_state, good = state, answers
    n = rows.shape[0]
    state0, _ = in_place(rows, queries, cfg, seed, "float32", [], k, nprobe,
                         dev, iters=0)
    judge("state_unchanged", state0, good)
    half = []
    for qi, v, i in good:
        v, i = v.copy(), i.copy()
        v[len(qi) // 2:], i[len(qi) // 2:] = -np.inf, -1
        half.append((qi, v, i))
    judge("half_batch", good_state, half)
    altered = []
    for qi, v, i in good:
        i = i.copy()
        i[0, 0] = (i[0, 0] + n // 2) % n
        altered.append((qi, v, i))
    judge("answer_altered", good_state, altered)
    swapped = []
    for qi, v, i in good:
        v, i = v.copy(), i.copy()
        v[:, [0, 1]], i[:, [0, 1]] = v[:, [1, 0]], i[:, [1, 0]]
        swapped.append((qi, v, i))
    judge("answers_swapped", good_state, swapped)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, int(s), args.seconds, False, dev,
                           t_start=t0)
        emit({"workload": args.workload, "seed": int(s), "who": "program",
              "correct": res["correct"],
              "numbers": {n: r["value"] for n, r in res["check"].items()},
              "metrics": {n: r["value"] for n, r in res["metrics"].items()},
              "seconds": time.perf_counter() - t0})
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        for who, nums in control_readings(args.workload, int(s), dev).items():
            emit({"workload": args.workload, "seed": int(s), "who": who,
                  "numbers": nums})
        print(f"[readings] control seed {s}: "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
