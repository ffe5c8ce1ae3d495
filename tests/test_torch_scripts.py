"""The port's experiment fan-out CLIs (`cli.mk_folds`, `cli.mk_datasets`)
against the JAX package's: both write the same `config.json` files, byte for
byte, and skip, report and overwrite in the same cases. Then the fold
fan-out of `tests/test_campaign.py` through the port's own train and
evaluate CLIs on the CPU."""
import json
import os

import numpy as np
import pytest

from paths_tpu.cli.mk_datasets import main as j_mk_datasets
from paths_tpu.cli.mk_folds import main as j_mk_folds
from test_scripts import base_config

from paths_tpu_torch.cli.mk_datasets import main as mk_datasets
from paths_tpu_torch.cli.mk_folds import main as mk_folds


def _write(path, cfg):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f)


def _tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _both(tmp_path, setup, run_port, run_jax):
    """Run the two packages' CLI on two copies of one tree; return the
    trees and what each printed."""
    trees, printed = {}, {}
    for name, run in (("torch", run_port), ("jax", run_jax)):
        root = str(tmp_path / name / "models")
        setup(root)
        printed[name] = run(root)
        trees[name] = _tree(root)
    return trees, printed


def test_mk_folds_matches_jax(tmp_path, capsys):
    def setup(root):
        _write(os.path.join(root, "exp_0", "config.json"), base_config())

    def runner(main):
        def run(root):
            main(["-n", "exp", "-f", "3", "--root", root, "--force"])
            main(["-n", "exp", "-f", "3", "--root", root, "--force"])
            return capsys.readouterr().out.replace(root, "ROOT")
        return run

    trees, printed = _both(tmp_path, setup, runner(mk_folds),
                           runner(j_mk_folds))
    assert trees["torch"] == trees["jax"] and len(trees["torch"]) == 3
    assert printed["torch"] == printed["jax"]
    assert "up to date" in printed["torch"]
    for i in range(3):
        cfg = json.loads(trees["torch"][f"exp_{i}/config.json"])
        assert cfg["seed"] == i and cfg["wsi_dir"] == "/data/brca"


@pytest.mark.parametrize("answer", ["y", "n"])
def test_mk_folds_differing_config_asks(tmp_path, monkeypatch, capsys, answer):
    """An existing fold config that differs: its diff is printed and, without
    --force, the answer to the prompt decides."""
    monkeypatch.setattr("builtins.input", lambda prompt: answer)

    def setup(root):
        _write(os.path.join(root, "exp_0", "config.json"), base_config())
        _write(os.path.join(root, "exp_1", "config.json"),
               {**base_config(), "seed": 1, "lr": 0.5})

    def runner(main):
        def run(root):
            main(["-n", "exp", "-f", "2", "--root", root])
            return capsys.readouterr().out.replace(root, "ROOT")
        return run

    trees, printed = _both(tmp_path, setup, runner(mk_folds),
                           runner(j_mk_folds))
    assert trees["torch"] == trees["jax"]
    assert printed["torch"] == printed["jax"]
    assert "lr: 0.5 -> None" in printed["torch"]
    cfg = json.loads(trees["torch"]["exp_1/config.json"])
    assert ("lr" in cfg) == (answer == "n")


@pytest.mark.parametrize("force", [True, False])
def test_mk_datasets_matches_jax(tmp_path, capsys, force):
    """The four sibling cohorts, with paths rewritten; without --force an
    existing, differing sibling is reported and left alone."""
    def setup(root):
        _write(os.path.join(root, "brca_paths_0", "config.json"),
               base_config())
        _write(os.path.join(root, "kirc_paths_0", "config.json"),
               {**base_config(), "seed": 7})

    def runner(main):
        def run(root):
            main(["-s", os.path.join(root, "brca_paths_0")]
                 + ["--force"] * force)
            return capsys.readouterr().out.replace(root, "ROOT")
        return run

    trees, printed = _both(tmp_path, setup, runner(mk_datasets),
                           runner(j_mk_datasets))
    assert trees["torch"] == trees["jax"]
    assert printed["torch"] == printed["jax"]
    for ds in ["coadread", "kirp", "luad"]:
        cfg = json.loads(trees["torch"][f"{ds}_paths_0/config.json"])
        assert cfg["wsi_dir"] == f"/data/{ds}"
        assert cfg["preprocess_dir"] == f"/data/{ds}_uni"
        assert cfg["csv_path"] == f"/data/{ds}_meta.csv.zip"
    kirc = json.loads(trees["torch"]["kirc_paths_0/config.json"])
    assert kirc["seed"] == (0 if force else 7)


def test_mk_datasets_needs_a_known_cohort(tmp_path):
    src = str(tmp_path / "models" / "brca_paths_0")
    _write(os.path.join(src, "config.json"),
           {**base_config(), "wsi_dir": "/data/unknown"})
    for main in (mk_datasets, j_mk_datasets):
        with pytest.raises(ValueError, match="Couldn't detect"):
            main(["-s", src])


def test_campaign_mk_folds_train_evaluate(tmp_path):
    """The fold fan-out, then each fold trained and evaluated through the
    port's CLIs on the CPU (`tests/test_campaign.py` with the port)."""
    from test_train_loop import tiny_train_config

    from paths_tpu_torch.cli.evaluate import main as evaluate
    from paths_tpu_torch.cli.train import main as train
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.synthetic import (
        make_synthetic_metadata,
        make_synthetic_store,
    )

    tmp = str(tmp_path)
    jcfg = tiny_train_config(tmp, num_epochs=1, hipt_splits=False)
    root = os.path.join(tmp, "models")
    fold0 = os.path.join(root, "brca_paths_0")
    jcfg.save(fold0)
    cfg = Config.load(fold0, test_mode=True)
    ids = make_synthetic_store(cfg.preprocess_dir, cfg, num_slides=12,
                               base_hw=(3, 3))
    make_synthetic_metadata(cfg.csv_path, ids)
    mk_folds(["-n", "brca_paths", "-f", "2", "--root", root, "--force"])
    mk_datasets(["-s", fold0, "--force"])
    assert os.path.isfile(os.path.join(root, "coadread_paths_0",
                                       "config.json"))

    vals = []
    for i in range(2):
        mdir = os.path.join(root, f"brca_paths_{i}")
        train(["-m", mdir, "--no-wandb", "--device", "cpu"])
        assert os.path.isfile(os.path.join(mdir, "model.npz"))
        vals.append(evaluate(["-m", mdir, "--split", "test", "--device",
                              "cpu"])["test_c-index"])
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals), vals
