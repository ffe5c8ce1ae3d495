"""Driver of serving cells: the port's `ServingSession` on the cohort.

Set-up writes (or finds) the cohort's store, writes a model directory (the
configuration and the weights drawn from the seed), opens the session with
the traffic's `cache_batches`, and sends the traffic's warm-up requests.

The window is a closed loop with one client: request after request, each
`request_slides` slides, drawn from the seed either afresh from the whole
cohort (`requests: "distinct"`) or from a working set of `working_set`
requests drawn once (`requests: "working_set"`). The metric counts the
slides whose predictions came back.

The check: a sample of the window's requests drawn from the seed, with the
request that holds the cohort's largest slide; for each slide in them the
reference's hazards, worked out from the store's raw grids in float64,
against the returned ones.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline
from benchmark.drivers import cohort as co
from benchmark.drivers.common import FlashLaunches, matmul_precision, sample_rng
from benchmark.inputs import cohort as cohort_inputs
from benchmark.inputs.weights import paths_weights
from benchmark.reference import paths_model


class Driver:
    def __init__(self, run):
        self.run = run
        self.dims = paths_model.Dims.of(run.config["model"])
        self.tr = run.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from paths_tpu_torch.serve import ServingSession

        run, dev, tr = self.run, self.run.device, self.tr
        self.spec = co.cohort_spec(run)
        self.root, self.ids = cohort_inputs.store(self.spec, run.cache, dev)
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        config = co.program_config(run, self.root)
        w = paths_weights(self.dims, run.seed, dev)
        path = co.model_dir(run, config, w)
        del w
        self.session = ServingSession(path, store_root=self.root,
                                      batch_size=tr["request_slides"],
                                      cache_batches=tr["cache_batches"],
                                      device=dev)
        self.rng = np.random.default_rng([int(run.seed), 0x5E7])
        if tr["requests"] == "working_set":
            self.working = [self._draw() for _ in range(tr["working_set"])]
        self.log: List[tuple] = []      # (slide indices, hazards, seconds)
        for idx in getattr(self, "working", []):
            self._request(idx)
        for _ in range(tr["warmup_requests"]):
            self._request()
        self.log.clear()

    def _draw(self) -> np.ndarray:
        return self.rng.choice(len(self.ids), size=self.tr["request_slides"],
                               replace=False)

    def _next(self) -> np.ndarray:
        if self.tr["requests"] == "working_set":
            return self.working[int(self.rng.integers(len(self.working)))]
        return self._draw()

    def _request(self, idx=None) -> None:
        idx = self._next() if idx is None else idx
        ids = [self.ids[i] for i in idx]
        t = time.perf_counter()
        with self.run.span("bench.predict"):
            rows = self.session.predict(ids)
        dt = time.perf_counter() - t
        self.log.append((idx, np.array([r["hazards"] for r in rows]), dt))

    # ------------------------------------------------------------ window
    def _run_for(self, seconds: float) -> tuple:
        start = len(self.log)
        t0 = time.perf_counter()
        while True:
            self._request()
            if time.perf_counter() - t0 >= seconds:
                return start, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        start, dt = self._run_for(seconds)
        self.window_log = self.log[start:]
        self.window_s = dt
        slides = sum(len(idx) for idx, _, _ in self.window_log)
        return {"attempted": len(self.window_log), "failed": 0,
                "metrics": {"predict_slides_per_s": slides / dt}}

    def traced(self, seconds: float) -> None:
        self.flash = FlashLaunches()
        with self.flash.active():
            self._run_for(seconds)

    def release(self) -> None:
        self.session = None
        if self.run.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Stop what the driver started (also after a failure)."""
        self.session = None

    # ------------------------------------------------------------ check
    def sample(self) -> List[int]:
        """Positions in the window's log: `sample_requests` drawn from the
        seed, and the last request holding the cohort's largest slide."""
        rng = sample_rng(self.run.seed)
        n = len(self.window_log)
        k = min(n, self.tr["check"]["sample_requests"])
        picks = set(rng.choice(n, size=k, replace=False).tolist())
        sizes = [np.load(cohort_inputs.grid_path(self.root, sid, self.spec["base_power"]),
                         mmap_mode="r").shape[:2] for sid in self.ids]
        largest = int(np.argmax([h * w for h, w in sizes]))
        holding = [i for i, (idx, _, _) in enumerate(self.window_log) if largest in idx]
        if holding:
            picks.add(holding[-1])
        return sorted(picks)

    def reference(self, slides, dtype, tf32: bool, targets) -> Dict[int, paths_model.Result]:
        """slide -> the reference's result (the order nearest the program's
        hazards where a top-K boundary ties)."""
        p = {k: v.detach() for k, v in co.reference_weights(
            self.run, self.dims, dtype).items()}
        refc = co.RefCohort(self.root, self.spec, self.run.device, dtype)
        out = {}
        with torch.no_grad(), matmul_precision(tf32):
            for s in slides:
                out[s] = paths_model.nearest(
                    refc.descend(p, self.dims, self.ids[s]),
                    None if targets is None else torch.from_numpy(targets[s]))
        return out

    def _served(self) -> Dict[int, List[np.ndarray]]:
        got: Dict[int, List[np.ndarray]] = {}
        for i in self.sample():
            idx, hz, _ = self.window_log[i]
            for s, h in zip(idx.tolist(), hz):
                got.setdefault(s, []).append(h)
        return got

    @staticmethod
    def _gap(got: Dict[int, List[np.ndarray]], ref) -> float:
        return max(float(np.abs(h - ref[s].hazards.double().cpu().numpy()).max())
                   for s, hs in got.items() for h in hs)

    def check(self) -> Dict[str, tuple]:
        lim = self.tr["check"]["limits"]
        self.got = self._served()
        targets = {s: hs[0] for s, hs in self.got.items()}
        self.ref = self.reference(sorted(self.got), torch.float64, False, targets)
        return {"hazard_gap": (self._gap(self.got, self.ref), lim["hazard_gap"])}

    def control(self) -> Dict[str, Dict[str, float]]:
        """The reference in float32 with TF32 products in the program's
        place, on the same slides."""
        ctrl = self.reference(sorted(self.got), torch.float32, True,
                              {s: hs[0] for s, hs in self.got.items()})
        got = {s: [ctrl[s].hazards.double().cpu().numpy()] for s in ctrl}
        return {"tf32 reference": {"hazard_gap": self._gap(got, self.ref)}}

    # ------------------------------------------------------------ layers
    def useful_flops(self) -> float:
        """The window's slides' forwards over each bag's valid patches (the
        reference's bag lengths, the same every time a slide is served)."""
        served = sorted({s for idx, _, _ in self.window_log for s in idx.tolist()})
        ref = self.reference(served, torch.float64, False, None)
        per = {s: roofline.paths_slide_flops(ref[s].rows, self.dims) for s in served}
        return sum(per[s] for idx, _, _ in self.window_log for s in idx.tolist())
