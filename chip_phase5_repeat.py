#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase 5 on fresh trained states, to measure how
often its card-vs-CPU step check fails.

    python3 chip_phase5_repeat.py TREE SECONDS [--batches]

TREE is the root of a checkout whose chip_smoke.py and radnerf_tpu_torch
are used (`.` for this one). Until SECONDS have passed, each iteration
trains a fresh brick3 trainer TRAIN_STEPS steps and one more step (the
state phase 5 holds against the CPU), then runs that check:

- by default as phase 5 runs it (`train_vs_cpu(trainer, pin_gate=True)`:
  batch seed 3, the gate's output layer `gate/encoder/{w,b}/4` at its
  term scale on the card's forward, every other leaf at
  TRAIN_CPU_GRAD_RTOL of its largest entry with the CPU step running its
  own forward), printing both the check's worst leaf (`worst_checked`,
  `over`) and the worst over every leaf unpinned, the form phase 5 had
  before (`worst`, `unpinned_over`), and the gate's output bias
  `gate/encoder/b/4` unpinned;
- with --batches on seed 3 and each batch of PIN_SEEDS, unpinned and
  pinned to the card's forward (`pin_forward=True`, phase 6's form),
  printing the batches over the tolerance each way.

A failed check is recorded in the iteration's line, not raised. One
`PHASE5 {...}` JSON line per iteration. Needs one CUDA device.
"""
import json
import sys
import time

root, budget = sys.argv[1], float(sys.argv[2])
batches = "--batches" in sys.argv[3:]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
t_end = time.perf_counter() + budget
dev = torch.device("cuda")
cs.kernels.build()
cfg = cs.render_scene(dev)["cfg"]
store = cs.ray_store(cfg, dev)
failed = []
cs.check = lambda ok, what: None if ok else failed.append(what)
first = {}
leaf_report = cs.leaf_report


def tap(*a, **k):
    rows = leaf_report(*a, **k)
    first.setdefault("leaves", rows)
    return rows


cs.leaf_report = tap
tol = cs.TRAIN_CPU_GRAD_RTOL
it, per = 0, 0.0
while time.perf_counter() + per < t_end:
    t0 = time.perf_counter()
    failed.clear()
    first.clear()
    tr = cs.new_trainer(cfg, store, dev)
    tr.update_grid(warmup=True)
    tr.model_state = cs.init_mngp_state(cfg, device=dev)
    cs.fit(tr, cs.TRAIN_STEPS, "train")
    tr.train_step(cs.tt.sample_batch(tr.gen, tr.data, tr.tcfg.batch_size))
    if batches:
        rep = cs.train_vs_cpu(tr, pin_forward=True)
    else:
        rep = cs.train_vs_cpu(tr, pin_gate=True)
    per = time.perf_counter() - t0
    rec = {"tree": root, "iter": it, "worst": rep[0]["worst"],
           "worst_leaf": rep[0]["worst_leaf"]}
    if batches:
        rec.update(
            batches=len(rep),
            unpinned_over=[[r["seed"], r["worst"], r["worst_leaf"]]
                           for r in rep if r["worst"] > tol],
            unpinned_max=max(r["worst"] for r in rep),
            pinned_over=[[r["seed"], r.get("worst_pinned")] for r in rep
                         if (r.get("worst_pinned") or 0) > tol],
            pinned_max=max(r.get("worst_pinned") or 0 for r in rep))
    else:
        b4 = next(r for r in first["leaves"]
                  if r["leaf"] == "gate/encoder/b/4")
        rec.update(b4_ratio=b4["ratio"], b4_card=b4["card"],
                   b4_cpu=b4["cpu"], unpinned_over=rec["worst"] > tol,
                   worst_checked=rep[0].get("worst_checked"),
                   over=(rep[0].get("worst_checked") or 0) > tol,
                   gate_out=rep[0].get("gate_out"),
                   planted=rep[0].get("planted_gate_half"))
    rec.update(failed=sorted(set(failed)), seconds=round(per, 1))
    print("PHASE5 " + json.dumps(rec), flush=True)
    it += 1
