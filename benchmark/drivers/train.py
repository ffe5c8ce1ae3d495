"""Driver of training cells: the port's trainer on the cohort.

Set-up writes (or finds) the cohort's store, builds the labelled dataset
as the trainer does (every slide's tables built up front), draws the
weights from the seed, and builds one training step: the model, AdamW and
`train.loop.make_step_fns`'s `update`. The loop is `train_loop`'s: per
epoch the trainer's own `_epoch_batches` (shuffled with the epoch's seed,
collated on its prefetch thread, padded to one shape) and `update`, each
step's outputs registered one step late (`_DeferredRegister`), the epoch's
train metric at its end. There is no evaluation and no checkpoint.

Set-up drives that loop through its first three steps and keeps what the
check needs: the losses, the first gradient as AdamW's state holds it after
one step, and the parameters before the first step and after the third.
The window goes on with the same loop, epoch after epoch.

The check: the reference works out the batch order from the epoch seeds,
follows the same three steps from the same weights in float64 (forward,
loss, autograd, AdamW), and each step's loss, each leaf's first gradient
norm and each leaf's change over the three steps are compared.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline
from benchmark.drivers import cohort as co
from benchmark.drivers.common import FlashLaunches, matmul_precision
from benchmark.inputs import cohort as cohort_inputs
from benchmark.inputs.weights import paths_weights
from benchmark.reference import paths_model

BETA1 = 0.9
FIRST_STEPS = 3


@dataclass
class Step:
    weights: np.ndarray        # the padded batch's row weights
    loss: torch.Tensor
    pred: torch.Tensor
    rows: torch.Tensor         # (B, levels) valid rows per bag and level


class Driver:
    def __init__(self, run):
        self.run = run
        self.dims = paths_model.Dims.of(run.config["model"])

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from paths_tpu_torch.data.dataset import SlideDataset, union_pads
        from paths_tpu_torch.data.feature_store import FeatureStore
        from paths_tpu_torch.train.evaluators import make_evaluator
        from paths_tpu_torch.train.loop import (
            make_optimizer,
            make_step_fns,
            set_matmul_precision,
        )

        run, dev = self.run, self.run.device
        self.spec = co.cohort_spec(run)
        self.root, self.ids = cohort_inputs.store(self.spec, run.cache, dev)
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.config = co.program_config(run, self.root)
        self.labels = co.labels(run.seed, len(self.ids), self.dims.n_logits)
        self.ds = SlideDataset(self.ids, self.config, FeatureStore(self.root),
                               cache_slides=True, labels=self.labels,
                               preload=True)
        self.pads = union_pads(self.ds.global_pads())
        set_matmul_precision(self.config.compute_dtype)
        w = paths_weights(self.dims, run.seed, dev)
        self.model = co.program_model(self.config, w, dev)
        del w
        self.optimizer = make_optimizer(self.config, self.model.parameters())
        self.update, _ = make_step_fns(self.config, self.optimizer)
        self.generator = torch.Generator(device=dev).manual_seed(run.seed)
        self.evaluator = make_evaluator(self.config, "train")
        self.train_stats: dict = {"train_loss": {}, "train_c-index": {}}
        self.batch_size = self.config.batch_size[0]
        self.waits: List[float] = []
        self.events: List[tuple] = []
        self.steps_taken: List[Step] = []
        self.loop = self._loop()

        from paths_tpu_torch.convert import jax_keys
        names = jax_keys(self.model)
        params = dict(self.model.named_parameters())
        self.first = {"p0": {names[n]: p.detach().clone() for n, p in params.items()}}
        steps = [next(self.loop) for _ in range(FIRST_STEPS)]
        self.first["p3"] = {names[n]: p.detach().clone() for n, p in params.items()}
        self.first["losses"] = [float(s.loss) for s in steps]
        self.first["pred"] = [s.pred.double().cpu() for s in steps]
        self.first["g1"] = self._g1

    def epoch_seed(self, epoch: int) -> int:
        """`train_loop`'s shuffle seed of an epoch, the run's seed standing
        for the configuration's."""
        return self.run.seed * 100_003 + epoch

    def _loop(self):
        from paths_tpu_torch.train.loop import _DeferredRegister, _epoch_batches

        run, dev = self.run, self.run.device
        cuda = dev.startswith("cuda")
        epoch = 0
        while True:
            epoch += 1
            reg = _DeferredRegister(self.evaluator)
            batches = _epoch_batches(self.ds, self.batch_size, shuffle=True,
                                     seed=self.epoch_seed(epoch),
                                     config=self.config, pads=self.pads,
                                     device=dev)
            try:
                while True:
                    t = time.perf_counter()
                    with run.span("bench.next_batch"):
                        item = next(batches, None)
                    self.waits.append(time.perf_counter() - t)
                    if item is None:
                        break
                    bag0, tables, labels, w = item
                    if cuda:
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                    with run.span("bench.update"):
                        loss, aux = self.update(self.model, bag0, tables, labels,
                                                self.generator, epoch=epoch,
                                                denom=float(w.sum()))
                    if cuda:
                        e1.record()
                        self.events.append((e0, e1))
                    with run.span("bench.register"):
                        reg.push(labels, aux["pred"], loss, w)
                    rows = torch.stack([(imp > 0).sum(dim=1)
                                        for imp in aux["importances"]], dim=1)
                    step = Step(w, loss, aux["pred"], rows)
                    self.steps_taken.append(step)
                    if len(self.steps_taken) == 1:
                        self._g1 = self._grads_from_state()
                    yield step
            finally:
                batches.close()
            with run.span("bench.epoch_end"):
                reg.flush()
                self.evaluator.calculate(self.train_stats, epoch)
                self.evaluator.reset()

    def _grads_from_state(self) -> Dict[str, torch.Tensor]:
        """The first step's gradient per leaf, from AdamW's first moment
        after one step (m = (1 - beta1) g); a leaf without state had none."""
        from paths_tpu_torch.convert import jax_keys

        names = jax_keys(self.model)
        out = {}
        for n, p in self.model.named_parameters():
            st = self.optimizer.state.get(p)
            out[names[n]] = (st["exp_avg"].detach() / (1.0 - BETA1)).clone() \
                if st and "exp_avg" in st else None
        return out

    # ------------------------------------------------------------ window
    def _run_for(self, seconds: float) -> tuple:
        start = len(self.steps_taken)
        w0 = len(self.waits)
        t0 = time.perf_counter()
        for _ in self.loop:
            if time.perf_counter() - t0 >= seconds:
                break
        self.run.sync()
        return start, w0, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        start, w0, dt = self._run_for(seconds)
        steps = self.steps_taken[start:]
        self.window_steps = steps
        self.window_s = dt
        self.window_waits = self.waits[w0:]
        self.window_events = self.events[start:]
        slides = sum(float(s.weights.sum()) for s in steps)
        return {"attempted": len(steps), "failed": 0,
                "metrics": {"train_slides_per_s": slides / dt}}

    def traced(self, seconds: float) -> None:
        self.flash = FlashLaunches()
        with self.flash.active():
            self._run_for(seconds)

    def release(self) -> None:
        self.loop.close()
        self.window_step_ms = [e0.elapsed_time(e1) for e0, e1 in self.window_events]
        self.window_rows = [s.rows.cpu().numpy() for s in self.window_steps]
        self.model = self.optimizer = self.update = None
        self.ds = None
        if self.run.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Stop what the driver started (also after a failure)."""
        loop = getattr(self, "loop", None)
        if loop is not None:
            loop.close()

    # ------------------------------------------------------------ check
    def batches(self) -> List[tuple]:
        """The first steps' (epoch, padded indices, weights), worked out
        from the epoch seeds as the trainer pads and shuffles."""
        n, bs = len(self.ids), self.batch_size
        out = []
        epoch = 0
        while len(out) < FIRST_STEPS:
            epoch += 1
            order = np.arange(n)
            np.random.default_rng(self.epoch_seed(epoch)).shuffle(order)
            for s in range(0, n, bs):
                idx = order[s: s + bs].tolist()
                w = [1.0] * len(idx) + [0.0] * (bs - len(idx))
                idx = idx + [idx[-1]] * (bs - len(idx))
                out.append((epoch, idx, w))
        return out[:FIRST_STEPS]

    def follow(self, dtype, tf32: bool) -> dict:
        """The reference through the first steps: losses, first gradient and
        change of every leaf."""
        cfg = self.run.config["model"]
        p = co.reference_weights(self.run, self.dims, dtype)
        p0 = {k: v.detach().clone() for k, v in p.items()}
        opt = paths_model.AdamW(cfg["lr"], cfg["weight_decay"])
        refc = co.RefCohort(self.root, self.spec, self.run.device, dtype)
        losses, g1 = [], None
        with matmul_precision(tf32):
            for i, (epoch, idx, w) in enumerate(self.batches()):
                total = sum(w)
                loss = 0.0
                for row, (sid_i, wi) in enumerate(zip(idx, w)):
                    if wi == 0:
                        continue
                    res = paths_model.nearest(refc.descend(p, self.dims, self.ids[sid_i]),
                                              self.first["pred"][i][row])
                    loss = loss + wi * paths_model.nll_survival(
                        res.hazards, int(self.labels["survival_bin"][sid_i]),
                        float(self.labels["censored"][sid_i]))
                loss = loss / total
                names = list(p)
                grads = torch.autograd.grad(loss, [p[k] for k in names],
                                            allow_unused=True)
                grads = dict(zip(names, grads))
                if i == 0:
                    g1 = {k: (None if g is None else g.detach().clone())
                          for k, g in grads.items()}
                losses.append(float(loss.detach()))
                lr = cfg["lr"] * cfg["lr_decay_per_epoch"] ** (epoch - 1)
                opt.step(p, grads, lr)
        change = {k: (p[k].detach() - p0[k]) for k in p}
        return {"losses": losses, "g1": g1, "change": change}

    def compare(self, got: dict, want: dict) -> Dict[str, float]:
        """loss_gap: the worst step's relative loss gap; grad_gap and
        change_gap: the worst leaf's gap between norms, over the larger of
        the reference leaf's norm and the median leaf's. Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out of the change (they move by round-off alone)."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))

        def norm(t):
            return 0.0 if t is None else float(t.double().norm())

        gref = {k: norm(v) for k, v in want["g1"].items()}
        moved = [v for k, v in gref.items() if want["g1"][k] is not None]
        gmed = float(np.median(moved))
        grad_gap = max(abs(norm(got["g1"].get(k)) - gref[k]) / max(gref[k], gmed)
                       for k in gref)
        keep = [k for k in gref if gref[k] >= 1e-3 * gmed]
        cref = {k: norm(want["change"][k]) for k in keep}
        cmed = float(np.median(list(cref.values())))
        change_gap = max(abs(norm(got["change"][k]) - cref[k]) / max(cref[k], cmed)
                         for k in keep)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}

    def program_side(self) -> dict:
        f = self.first
        return {"losses": f["losses"], "g1": f["g1"],
                "change": {k: f["p3"][k] - f["p0"][k] for k in f["p0"]}}

    def check(self) -> Dict[str, tuple]:
        lim = self.run.traffic["check"]["limits"]
        self.ref = self.follow(torch.float64, tf32=False)
        nums = self.compare(self.program_side(), self.ref)
        return {k: (v, lim[k]) for k, v in nums.items()}

    def control(self) -> Dict[str, Dict[str, float]]:
        """The reference in float32 with TF32 products (the precision below
        the configuration's float32 with TF32 off) in the program's place."""
        return {"tf32 reference": self.compare(self.follow(torch.float32, tf32=True),
                                               self.ref)}

    # ------------------------------------------------------------ layers
    def useful_flops(self) -> float:
        """Forward + backward (3 forwards) of the window's steps, over the
        real rows and each bag's valid patches."""
        total = 0.0
        for s, rows in zip(self.window_steps, self.window_rows):
            for wi, r in zip(s.weights, rows):
                if wi > 0:
                    total += 3.0 * roofline.paths_slide_flops(r.tolist(), self.dims)
        return total
