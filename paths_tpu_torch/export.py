"""Serving export: the trained hierarchical forward frozen into a program
that runs without the model code (counterpart of `paths_tpu.export`).

`torch.export` traces the prediction-only forward (`make_serving_fn`) into
an ATen graph for the input shapes of one representative batch; the artifact
is a stored zip holding one `torch.export.save` program per platform
(`cuda.pt2`, `cpu.pt2`), each traced on its device, because the attention
route depends on the device. On the card the graph calls the hand-written
flash kernel through the operator `paths_torch::flash_attention_fwd`
(`kernels/flash_attention.py`), so loading an artifact needs
`paths_tpu_torch.kernels.flash_attention` imported to register that
operator (`load_serving` imports it); nothing else of the model code is
needed.

Two flavours, as in the JAX package:

- **weights as arguments** (default): `call(params, bag, tables)`, with
  `params` the flat `{name: tensor}` of `RecursiveModel.named_parameters()`
  (`torch.func.functional_call` binds them). The program holds no weights;
  the serving host loads them from the checkpoint.
- **frozen** (`freeze_params=True`): `call(bag, tables)`; the weights are
  the program's constants. One self-contained file.

Only dicts and lists of tensors cross the boundary: the bag and each level
table travel as plain dicts (`bag_to_dict`, `tables_to_dicts`). With
`poly_batch` the leading axis of every bag and table input is a symbolic
dimension (traced at a batch of at least 2, repeating the example's slides,
so that sizes 0 and 1 are not specialised), and one program serves any
batch; the patch, row and grid axes stay fixed.
"""
from __future__ import annotations

import copy
import io
import zipfile
from typing import List, Optional

import torch

from paths_tpu_torch.config import Config

BAG_FIELDS = ("fts", "locs", "mask", "parent_inds", "ctx_slide",
              "ctx_patch")
TABLE_FIELDS = ("fts", "locs", "count", "index", "grid_hw")
PLATFORMS = ("cuda", "cpu")


def bag_to_dict(bag) -> dict:
    return {f: getattr(bag, f) for f in BAG_FIELDS}


def tables_to_dicts(tables) -> List[dict]:
    return [{f: getattr(t, f) for f in TABLE_FIELDS} for t in tables]


def prediction(config: Config, logits: torch.Tensor) -> torch.Tensor:
    """Hazards (sigmoid) for survival, raw logits for subtype classification
    (`engine.hierarchy.task_loss`'s prediction)."""
    return torch.sigmoid(logits) if config.task == "survival" else logits


def make_serving_fn(config: Config):
    """Prediction-only forward over plain-dict inputs:

    (model, bag: dict, tables: [dict]) -> {"pred", "logits", "importances"}

    `pred` is the `prediction` of the last level's logits."""
    from paths_tpu_torch.engine.hierarchy import end2end_forward
    from paths_tpu_torch.engine.tables import LevelTable
    from paths_tpu_torch.models.batch import PatchBag

    def serve(model, bag: dict, tables: List[dict]) -> dict:
        outs = end2end_forward(model, config, PatchBag(**bag),
                               [LevelTable(**t) for t in tables])
        logits = outs[-1]["logits"]
        return {"pred": prediction(config, logits), "logits": logits,
                "importances": [o["importance"] for o in outs]}

    return serve


class _Serving(torch.nn.Module):
    """call(bag, tables) with the model a submodule: exported as it is, its
    weights are lifted into the program (the frozen flavour)."""

    def __init__(self, config: Config, model):
        super().__init__()
        self.model = model
        self.serve = make_serving_fn(config)

    def forward(self, bag, tables):
        return self.serve(self.model, bag, tables)


class _WeightsAsArgs(torch.nn.Module):
    """call(params, bag, tables): every parameter of the model is bound from
    `params`. The `_Serving` module is held outside the module tree, so none
    of its tensors is lifted into the program."""

    def __init__(self, serving: _Serving):
        super().__init__()
        self.__dict__["_serving"] = serving

    def forward(self, params, bag, tables):
        bound = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self._serving, bound,
                                          (bag, tables), strict=True)


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to(v, device) for v in x]
    return x.to(device)


def _repeat_to(x, n: int):
    """Every leaf with its leading axis tiled up to at least n rows."""
    if isinstance(x, dict):
        return {k: _repeat_to(v, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_repeat_to(v, n) for v in x]
    reps = -(-n // x.shape[0])
    return x.repeat(reps, *([1] * (x.dim() - 1)))[:max(n, x.shape[0])]


def export_serving(config: Config, model, bag, tables, *,
                   freeze_params: bool = False, poly_batch: bool = False,
                   platforms: Optional[List[str]] = None) -> bytes:
    """Serialize the serving forward for the SHAPES of `bag` / `tables` (a
    `PatchBag` and `LevelTable` list, or the equivalent dicts). `platforms`
    (default: the device of `bag`'s tensors) takes "cuda" and/or "cpu"; each
    gets a program traced on that device, and a platform this host lacks
    raises. `model` is a `RecursiveModel`; it is not changed."""
    bag_d = bag if isinstance(bag, dict) else bag_to_dict(bag)
    tab_d = (tables if tables and isinstance(tables[0], dict)
             else tables_to_dicts(tables))
    platforms = list(platforms or [bag_d["fts"].device.type])
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}: the port exports for "
                             f"{PLATFORMS}")
        if p == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a cuda program needs a card on the exporting "
                               "host")
    if poly_batch and bag_d["mask"].shape[0] < 2:
        bag_d, tab_d = _repeat_to(bag_d, 2), _repeat_to(tab_d, 2)

    dynamic = None
    if poly_batch:
        batch = torch.export.Dim("batch", min=1)
        lead = lambda d: {k: {0: batch} for k in d}   # noqa: E731
        dynamic = {"bag": lead(bag_d), "tables": [lead(t) for t in tab_d]}

    # the kernel route without autograd: the weights require no grad
    model = copy.deepcopy(model).eval().requires_grad_(False)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for p in platforms:
            dev = torch.device(p)
            m = model.to(dev)
            args = (_to(bag_d, dev), _to(tab_d, dev))
            wrapper = _Serving(config, m)
            if not freeze_params:
                wrapper = _WeightsAsArgs(wrapper)
                args = ({k: v.detach() for k, v in m.named_parameters()},
                        ) + args
            shapes = dynamic
            if dynamic is not None and not freeze_params:
                shapes = {"params": {k: None for k in args[0]}, **dynamic}
            with torch.no_grad():
                ep = torch.export.export(wrapper, args,
                                         dynamic_shapes=shapes)
            # the program keeps its example inputs, which `save` would
            # write out: a flagship batch is 1.7 GiB of tables
            ep.example_inputs = None
            prog = io.BytesIO()
            torch.export.save(ep, prog)
            zf.writestr(f"{p}.pt2", prog.getvalue())
    return buf.getvalue()


class ServingArtifact:
    """A loaded artifact: `programs` maps each platform to its
    `torch.export.ExportedProgram`; `call(*args)` runs the program of the
    inputs' device."""

    def __init__(self, programs: dict):
        self.programs = programs
        self.platforms = list(programs)
        self._modules = {}

    def program(self, platform: str = None):
        return self.programs[platform or self.platforms[0]]

    def call(self, *args):
        bag = args[-2]
        platform = bag["fts"].device.type
        if platform not in self.programs:
            raise ValueError(f"artifact has no {platform} program (platforms "
                             f"{self.platforms})")
        if platform not in self._modules:
            self._modules[platform] = self.programs[platform].module()
        return self._modules[platform](*args)


def load_serving(blob: bytes) -> ServingArtifact:
    """Deserialize an artifact (registers the flash operator first)."""
    import paths_tpu_torch.kernels.flash_attention  # noqa: F401

    programs = {}
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for name in zf.namelist():
            programs[name[:-len(".pt2")]] = torch.export.load(
                io.BytesIO(zf.read(name)))
    return ServingArtifact(programs)


def artifact_signature(exp: ServingArtifact) -> tuple:
    """(frozen, batch_size, pads) read from the program's own inputs: the
    calling convention is `(params, bag, tables)` or, frozen, `(bag,
    tables)`. `pads` is a `SlideDataset.global_pads()`-style dict; collate
    with `level0_bucket=1, row_bucket=1, grid_bucket=1, pads=pads` to get
    the shapes the program takes. `batch_size` is None for a `poly_batch`
    artifact."""
    ep = exp.program()
    shapes = [n.meta["val"].shape for n in ep.graph.nodes
              if n.op == "placeholder"
              and n.name in ep.graph_signature.user_inputs]
    args, _ = torch.utils._pytree.tree_unflatten(shapes, ep.call_spec.in_spec)
    bag, tables = args[-2], args[-1]
    if set(bag) != set(BAG_FIELDS):
        raise ValueError(f"not a serving artifact: bag fields {sorted(bag)}")
    b, n0 = bag["mask"]
    rows = [0] + [int(t["fts"][1]) for t in tables]
    grid_hw = [(0, 0)] + [(int(t["index"][1]), int(t["index"][2]))
                          for t in tables]
    batch = int(b) if isinstance(b, int) else None   # symbolic -> None
    return (len(args) == 2, batch,
            {"n0": int(n0), "rows": rows, "grid_hw": grid_hw})


def artifact_pads(exp: ServingArtifact) -> tuple:
    """(batch_size, pads); see `artifact_signature`."""
    _, batch, pads = artifact_signature(exp)
    return batch, pads
