"""The port's end-to-end entry points on the CPU
(`paths_tpu_torch/examples/*`, `paths_tpu_torch/tools/profile_step.py`),
against the JAX package's scripts and CLIs where both run.

* The dress rehearsal's and the cohort soak's recipes give the config of
  the JAX package's committed records field by field, but for the paths
  under the work dir and `attention_impl`.
* A narrowed rehearsal (3 levels, widths 64 / 32, level-0 bucket 32,
  dropout 0, 14 slides, 2 epochs) through both packages' `cli.train` and
  `cli.evaluate` on one store and one `model.npz`, JAX on its recipe's
  plain attention and the port on its kernel route (here the kernels' plain
  versions): f32 on the CPU differs only in summation order, so per-epoch
  train losses and the test metrics agree to 1e-5 relative and the val
  c-index exactly (a c-index moves only when two predictions swap).
* The soak's summary and slope code, the rehearsal's draws over seeds and
  initial weights, the demo's nine stages and the profiler's trace parser
  and workload run here at small sizes; the profiler refuses the CPU, which
  has no device events. Work dirs default to new temp dirs, and a named
  one's store is reused only where it was made with the same parameters.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from paths_tpu.cli.evaluate import main as jevaluate
from paths_tpu.cli.train import main as jtrain
from paths_tpu.config import Config as JConfig
from paths_tpu.models.recursive import recursive_init

from paths_tpu_torch import convert
from paths_tpu_torch.cli.evaluate import main as tevaluate
from paths_tpu_torch.cli.train import main as ttrain
from paths_tpu_torch.encoders import registry
from paths_tpu_torch import examples
from paths_tpu_torch.examples import REPO, cohort_soak, flagship_dress_rehearsal
from paths_tpu_torch.examples import rehearsal_draws, run_synthetic_demo
from paths_tpu_torch.models import jax_init
from paths_tpu_torch.tools import profile_step

REL = 1e-5
JAX_RECORDS = os.path.join(REPO, "examples", "records")
# fields that may differ from the JAX records, and why
WORKDIR_PATHS = ("wsi_dir", "csv_path", "preprocess_dir")   # the run's dir
PORT_DEPARTURES = {"attention_impl": ("xla", "pallas")}      # kernel #1


@pytest.fixture(autouse=True)
def one_thread():
    """The port's ops on one thread: under the tier-1 run's six workers,
    torch's intra-op threads wait on each other at every small op (the soak
    case took 171 s against 27 s on one thread, on 8 busy cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("module,record,task", [
    (flagship_dress_rehearsal, "flagship_dress_rehearsal", "survival"),
    (flagship_dress_rehearsal, "flagship_dress_rehearsal_subtype", "subtype"),
    (cohort_soak, "cohort_soak", "survival"),
    (cohort_soak, "cohort_soak_subtype", "subtype"),
])
def test_recipe_matches_jax_record_config(tmp_path, module, record, task):
    with open(os.path.join(JAX_RECORDS, record, "config.json")) as f:
        want = json.load(f)
    got = module.recipe(task, str(tmp_path), epochs=want["num_epochs"],
                        seed=want["seed"]).to_dict()
    assert set(got) == set(want)
    for key in WORKDIR_PATHS:
        assert os.path.dirname(got[key]) == str(tmp_path), key
        assert os.path.basename(got[key]) == os.path.basename(want[key]), key
    for key, (jax_value, port_value) in PORT_DEPARTURES.items():
        assert (want[key], got[key]) == (jax_value, port_value), key
    for key in set(want) - set(WORKDIR_PATHS) - set(PORT_DEPARTURES):
        assert got[key] == want[key], key


def _narrowed_model(changes):
    """The flagship model at small widths, with `changes` to its model
    config."""
    cfg = flagship_dress_rehearsal.recipe("survival", "/nowhere")
    mc = cfg.model_config
    mc.patch_embed_dim, mc.trans_dim = 64, 32
    mc.importance_mlp_hidden_dim = mc.hierarchical_ctx_mlp_hidden_dim = 16
    for key, value in changes.items():
        setattr(mc, key, value)
    cfg.num_levels, cfg.top_k_patches = 3, [20, 20]
    return cfg


def _narrowed(tmp_path):
    """The rehearsal recipe at small widths and depth, dropout 0."""
    cfg = flagship_dress_rehearsal.recipe("survival", str(tmp_path / "wd"),
                                          epochs=2, seed=0)
    cfg.model_config.patch_embed_dim = 64
    cfg.model_config.trans_dim = 32
    cfg.model_config.dropout = 0.0
    cfg.num_levels = 3
    cfg.top_k_patches = [20, 20]
    cfg.level0_bucket = 32
    return cfg


def test_narrowed_rehearsal_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHS_TPU_CACHE", jax.config.jax_compilation_cache_dir)
    cfg = _narrowed(tmp_path)
    flagship_dress_rehearsal.write_signal_data(cfg, 14, 0, subtype=False,
                                               base_hw=(3, 4))
    dirs = {name: str(tmp_path / name) for name in ("jax", "torch")}
    for name, d in dirs.items():
        # each package its own recipe's route: JAX's plain attention, the
        # port's kernel route (here the kernels' plain versions); each CLI
        # draws the seed's initial weights itself
        cfg.attention_impl = {"jax": "xla", "torch": "pallas"}[name]
        cfg.save(d)
    jtrain(["-m", dirs["jax"], "--no-wandb"])
    tstats = ttrain(["-m", dirs["torch"], "--no-wandb", "--device", "cpu"])
    jtest = jevaluate(["-m", dirs["jax"], "--split", "test"])
    ttest = tevaluate(["-m", dirs["torch"], "--split", "test",
                       "--device", "cpu"])
    with open(os.path.join(dirs["jax"], "train_stats.json")) as f:
        jstats = json.load(f)
    assert sorted(tstats["train_loss"]) == [1, 2]
    for e in (1, 2):
        np.testing.assert_allclose(tstats["train_loss"][e],
                                   jstats["train_loss"][str(e)], rtol=REL)
        assert tstats["val_c-index"][e] == jstats["val_c-index"][str(e)]
    assert set(ttest) == set(jtest)
    for key in jtest:
        np.testing.assert_allclose(ttest[key], jtest[key], rtol=REL)


@pytest.mark.parametrize("changes", [
    {}, {"lstm": False}, {"slide_ctx_mode": "concat", "trans_heads": 2}])
@pytest.mark.parametrize("seed", [0, 5])
def test_initial_weights_are_jaxs(changes, seed):
    """The port's fresh runs start from JAX's `recursive_init(PRNGKey(seed))`:
    every uniform draw bit for bit, the normal special tokens within 4 f32
    ulps (XLA's erfinv polynomial, rounded alike but for log1p)."""
    cfg = _narrowed_model(changes)
    jcfg = JConfig(**json.loads(json.dumps(cfg.to_dict())))
    want = jax.tree_util.tree_flatten_with_path(
        recursive_init(jax.random.PRNGKey(seed), jcfg))[0]
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v) for path, v in want}
    got = jax_init.recursive_init_flat(cfg, seed)
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith("special_token"):
            np.testing.assert_allclose(got[key], value, rtol=5e-7, atol=0)
        else:
            assert got[key].dtype == value.dtype and \
                np.array_equal(got[key], value), key
    model = jax_init.fresh_model(cfg, seed)
    assert not any(p.is_meta for p in model.parameters())
    flat = convert.to_jax_flat(model)
    assert set(flat) == set(want)
    for key, value in got.items():
        assert np.array_equal(flat[key], value), key


def test_soak_summary_and_slope(tmp_path, monkeypatch):
    """Three epochs over a few narrowed slides on the CPU: the summary
    has the JAX record's keys and the train loop's per-epoch telemetry, and
    the slope is the least-squares fit from epoch 2 on."""
    wd = str(tmp_path / "soak")
    real = cohort_soak.recipe

    def small(task, workdir, epochs, seed):
        cfg = real(task, workdir, epochs, seed)
        cfg.model_config.patch_embed_dim = 64
        cfg.model_config.trans_dim = 32
        cfg.num_levels = 3
        cfg.top_k_patches = [20, 20]
        cfg.level0_bucket = 32
        return cfg

    monkeypatch.setattr(cohort_soak, "recipe", small)
    s = cohort_soak.main(["--workdir", wd, "--slides", "8", "--epochs", "3",
                          "--device", "cpu"])
    with open(os.path.join(JAX_RECORDS, "cohort_soak", "summary.json")) as f:
        want = json.load(f)
    assert set(want) <= set(s)
    assert s["backend"] == "cpu" and s["device"] is None
    assert sorted(s["epoch_wall_s"]) == sorted(s["host_rss_mb"]) == [1, 2, 3]
    rss = s["host_rss_mb"]
    slope = np.polyfit([2.0, 3.0], [rss[2], rss[3]], 1)[0]
    assert s["rss_slope_mb_per_epoch"] == round(slope, 1)
    assert cohort_soak.rss_slope({1: 5.0, 2: 7.0}) is None
    assert cohort_soak.rss_slope({1: 0.0, 2: 10.0, 3: 20.0, 4: 30.0}) == \
        pytest.approx(10.0)
    assert s["rss_mb_peak"] >= s["rss_mb_start"] > 0
    assert np.isfinite(s["test_metrics"]["test_c-index"])
    # a store made with other slides is not reused, nor a store unnamed
    with pytest.raises(ValueError, match="made with"):
        cohort_soak.main(["--workdir", wd, "--slides", "9", "--epochs", "3",
                          "--device", "cpu", "--keep-store"])
    with pytest.raises(SystemExit):
        cohort_soak.main(["--device", "cpu", "--keep-store"])
    # --keep-store rewrites the metadata for the subtype task over the store
    sub = cohort_soak.main(["--workdir", wd, "--slides", "8", "--epochs",
                            "3", "--device", "cpu", "--keep-store",
                            "--task", "subtype"])
    assert sub["store_gb"] == s["store_gb"]
    assert np.isfinite(sub["test_metrics"]["test_AUC"])


def test_rehearsal_draws_on_the_cpu(tmp_path, monkeypatch):
    """One seed from both initial weights through the narrowed recipe: the
    JAX init is the fresh model `cli.train` starts from, the module draw a
    different start; both routes score the test split alike (here the
    kernels' plain versions)."""
    real = flagship_dress_rehearsal.recipe

    def small(task, workdir, epochs=40, seed=0):
        cfg = real(task, workdir, epochs, seed)
        cfg.model_config.patch_embed_dim = 64
        cfg.model_config.trans_dim = 32
        cfg.num_levels = 3
        cfg.top_k_patches = [20, 20]
        cfg.level0_bucket = 32
        return cfg

    monkeypatch.setattr(flagship_dress_rehearsal, "recipe", small)
    out = rehearsal_draws.main(["--tasks", "survival", "--seeds", "1",
                                "--epochs", "2", "--slides", "14",
                                "--workdir", str(tmp_path / "draws"),
                                "--device", "cpu"])
    rows = {row["init"]: row for row in out["rows"]}
    assert sorted(rows) == ["jax", "module"] and out["device"] is None
    assert rows["jax"]["train_loss_first"] != rows["module"][
        "train_loss_first"]
    s = out["summary"]["survival/jax"]
    assert s["metric"] == "test_c-index" and list(s["by_seed"]) == [0]
    assert s["mean"] == rows["jax"]["test_c-index_pallas"]
    assert s["met_bar"] == int(s["mean"] >= rehearsal_draws.BAR)
    for summary in out["summary"].values():
        assert summary["max_route_gap_metric"] == 0.0
        assert summary["max_route_gap_loss"] <= 1e-5
    # each draw's model dir goes once it is scored; the slides stay
    left = os.listdir(tmp_path / "draws" / "survival")
    assert "store" in left and not any(
        n.startswith(rehearsal_draws.INITS) for n in left)


def test_work_dirs_and_store_stamps(tmp_path, monkeypatch):
    """Unnamed work dirs are new dirs under the temp dir (TMPDIR); a store
    is reused only where its stamp matches, and one without a stamp or
    made otherwise raises."""
    monkeypatch.setattr(examples.tempfile, "tempdir", str(tmp_path))
    a, made_a = examples.work_dir(None, "run")
    b, made_b = examples.work_dir(None, "run")
    assert made_a and made_b and a != b
    assert os.path.dirname(a) == os.path.dirname(b) == str(tmp_path)
    assert examples.work_dir("/named", "run") == ("/named", False)
    store = str(tmp_path / "store")
    assert not examples.store_made_with(store, slides=4, seed=0)
    os.makedirs(store)
    with pytest.raises(ValueError, match="made with None"):
        examples.store_made_with(store, slides=4, seed=0)
    examples.stamp_store(store, slides=4, seed=0, base_hw=[3, 4])
    assert examples.store_made_with(store, seed=0, base_hw=[3, 4], slides=4)
    with pytest.raises(ValueError, match="made with"):
        examples.store_made_with(store, slides=5, seed=0, base_hw=[3, 4])


def test_demo_runs_its_nine_stages_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The demo's nine stages with its encoder one block deep (a random
    timm-keyed checkpoint of that depth) and 6 slides, one epoch."""
    # in place: `cli.verify_conversion` holds the same dict
    spec, tspec = registry._VIT_SPECS["kaiko-vits16"]
    monkeypatch.setitem(registry._VIT_SPECS, "kaiko-vits16",
                        (dataclasses.replace(spec, depth=1), tspec))
    out = run_synthetic_demo.main(["--workdir", str(tmp_path / "demo"),
                                   "--slides", "6", "--epochs", "1",
                                   "--device", "cpu"])
    printed = capsys.readouterr().out
    for stage in range(1, 10):
        assert f"== {stage}/9 " in printed, stage
    assert "-> OK" in printed                       # verify_conversion
    assert "platforms=['cpu']" in printed           # the artifact reloads
    assert np.isfinite(out["metrics"]["test_loss"])
    assert len(out["served"]) == 2
    assert all(np.isfinite(r["risk"]) for r in out["served"])
    with open(out["predictions"]) as f:
        assert len(f.read().splitlines()) == 3      # header + 2 test slides


def _trace():
    """A hand-built torch.profiler trace: host events (cpu_op, cuda_runtime,
    python_function, a user annotation and its mirror on the device's
    timeline) beside the device's kernels, copies and fills."""
    def ev(cat, name, dur, ph="X"):
        return {"ph": ph, "cat": cat, "name": name, "dur": dur, "pid": 0,
                "tid": 7, "ts": 0}

    return {"traceEvents": [
        ev("cpu_op", "aten::mm", 900.0),
        ev("cuda_runtime", "cudaLaunchKernel", 800.0),
        ev("python_function", "torch/nn/modules/module.py(1736): _call_impl",
           700.0),
        ev("user_annotation", "Optimizer.step#AdamW.step", 600.0),
        ev("gpu_user_annotation", "Optimizer.step#AdamW.step", 500.0),
        ev("ac2g", "cudaLaunchKernel", 0.0, ph="f"),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4, "
           "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >"
           "(int, at::native::FillFunctor<float>, at::detail::Array<char*, "
           "1>)", 10.0),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<2, "
           "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >"
           "(int, at::native::FillFunctor<float>, at::detail::Array<char*, "
           "1>)", 5.0),
        ev("kernel", "void at::native::elementwise_kernel<128, 2, "
           "at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add"
           "<float> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add"
           "<float> const&)::{lambda(int)#1}>(int, at::native::CUDAFunctor_add"
           "<float>)", 4.0),
        ev("kernel", "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_"
           "nt_align1>(cutlass_80_simt_sgemm_128x64_8x5_nt_align1::Params)",
           6.0),
        ev("kernel", "void at::native::(anonymous namespace)::"
           "vectorized_layer_norm_kernel<float, float>(int, float, float "
           "const*, float const*, float const*, float*, float*, float*)",
           3.0),
        ev("kernel", "flash_fwd_f32_kernel_1", 20.0),
        ev("kernel", "flash_fwd_f32_kernel_2", 30.0),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 7.0),
        ev("gpu_memset", "Memset (Device)", 1.0),
    ]}


def test_profile_parser_keeps_device_lanes_and_merges_families():
    by_op, by_family, total = profile_step.device_op_table(_trace())
    assert total == pytest.approx(86.0)
    assert len(by_op) == 9
    assert by_family == {
        "at::native::vectorized_elementwise_kernel<FillFunctor>": 15.0,
        "at::native::elementwise_kernel<CUDAFunctor_add>": 4.0,
        "cutlass::Kernel<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>": 6.0,
        "at::native::(anonymous namespace)::vectorized_layer_norm_kernel": 3.0,
        "flash_fwd_f32_kernel": 50.0,
        "Memcpy HtoD": 7.0,
        "Memset": 1.0,
    }
    assert profile_step._op_family("all_gather") == "all_gather"
    assert profile_step._op_family("gemm.12") == "gemm"


def test_profile_parser_raises_without_device_events():
    host_only = {"traceEvents": [e for e in _trace()["traceEvents"]
                                 if e["cat"] not in profile_step.DEVICE_CATS]}
    with pytest.raises(ValueError, match="no device event"):
        profile_step.device_op_table(host_only)


@pytest.mark.parametrize("what", ["train", "eval"])
def test_profile_workload_takes_a_cpu_step(tmp_path, what):
    """`build_workload` at small widths and depth: one
    step on the CPU gives a finite loss (the train step moves the
    weights)."""
    cfg = profile_step.flagship_config(str(tmp_path))
    cfg.model_config.patch_embed_dim = 64
    cfg.model_config.trans_dim = 32
    cfg.num_levels = 3
    cfg.top_k_patches = [20, 20]
    cfg.level0_bucket = 32
    step = profile_step.build_workload(what, "cpu", cfg, batch=4,
                                       base_hw=(3, 4))
    loss, again = step(), step()
    assert torch.isfinite(loss) and torch.isfinite(again)
    assert (again != loss) == (what == "train")
    # the store is reused for the same workload, and refused for another
    profile_step.build_workload(what, "cpu", cfg, batch=4, base_hw=(3, 4))
    with pytest.raises(ValueError, match="made with"):
        profile_step.build_workload(what, "cpu", cfg, batch=3, base_hw=(3, 4))


def test_profile_step_refuses_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="the CPU has none"):
        profile_step.main(["--device", "cpu", "--workdir", str(tmp_path)])
