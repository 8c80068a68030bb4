"""The port's boundaries: what it imports and where it runs.

* no module under ``src/repro_torch/``, not ``chip_smoke.py``, no
  script under ``tools/`` and no port example (``examples/*_torch.py``)
  imports ``jax`` or anything of the JAX package ``repro`` (AST scan);
* without a card every entry point called without ``device=`` raises
  instead of running on the CPU (the fault runners and the supervisor
  among them) (``torch.cuda.is_available`` is patched
  to False, so the test means the same on a machine with a card);
* ``chip_smoke.py`` exits non-zero and prints no result without a card,
  and in a directory that holds nothing else of the repository.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert, resolve_device
from repro_torch.analysis import entrypoints as lint_entrypoints
from repro_torch.analysis import mesh as lint_mesh
from repro_torch.analysis import runner as lint_runner
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core import (algorithms, async_engine, deep_vfl, engine,
                              faults, losses, staleness, supervisor)
from repro_torch.launch import train as lm_train
from repro_torch.launch.serve import serve
from repro_torch.models import model as lm_model
from repro_torch.serve import ServeEngine
from repro_torch.sharding.api import PartyMesh, Runtime

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*.py")) \
    + sorted((REPO / "examples").glob("*_torch.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cpu_engine():
    x = np.ones((6, 4), np.float32)
    return engine.FusedEngine(losses.ridge(), x, np.ones(6, np.float32),
                              algorithms.PartyLayout.even(4, 2, 1),
                              device="cpu")


@pytest.mark.parametrize("entry", [
    "resolve_device", "FusedEngine", "ServeEngine", "linear_iterate",
    "deep_params", "svrg_state", "saga_state", "train", "train_fused",
    "train_multi_pipelined", "serve", "lm_params", "lm_init_params",
    "serve_dense", "lm_init_params_dense", "lm_init_cache_dense",
    "run_delayed_fused", "run_delayed_multi_fused", "init_state",
    "train_deep", "train_deep_fused", "train_deep_vfl",
    "train_centralized", "run_faulted_fused", "run_guarded_fused",
    "run_faulted_reference", "run_guarded_reference", "train_supervised",
    "supervised_train", "supervised_guarded_run", "run_deep_faulted_fused",
    "run_deep_guarded_fused", "run_deep_faulted_reference",
    "run_deep_guarded_reference", "supervised_guarded_run_deep",
    "FusedEngine_mesh", "ServeEngine_mesh", "run_async", "run_sync",
    "analysis_main", "analyze_matrix", "lint_mesh_run", "lint_mesh_spawn",
    "lint_mesh_start",
    "lm_train", "lm_make_train_batch",
    "serve_granite_moe", "serve_qwen3_moe", "lm_init_params_moe",
    "lm_init_cache_moe", "lm_params_moe", "lm_train_moe"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card,
                                                               entry,
                                                               tmp_path):
    x = np.ones((6, 4), np.float32)
    lay = algorithms.PartyLayout.even(4, 2, 1)
    trace = faults.FaultTrace(q=2, steps=3)
    ck = str(tmp_path / "ck")
    calls = {
        "resolve_device": lambda: resolve_device(),
        "FusedEngine": lambda: engine.FusedEngine(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1)),
        "ServeEngine": lambda: ServeEngine(_cpu_engine()),
        "linear_iterate": lambda: convert.linear_iterate(np.ones(4)),
        "deep_params": lambda: convert.deep_params((x, x, x, x)),
        "svrg_state": lambda: convert.svrg_state(np.ones(4), np.ones(4)),
        "saga_state": lambda: convert.saga_state(np.ones(6), np.ones(4)),
        "train": lambda: algorithms.train(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1),
        "train_fused": lambda: algorithms.train(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1,
            engine="fused"),
        "train_multi_pipelined": lambda: algorithms.train(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1,
            engine="fused", multi_dominator=True, pipelined=True),
        "serve": lambda: serve("falcon_mamba_7b", batch=1, prompt_len=2,
                               gen_tokens=1),
        "lm_params": lambda: convert.lm_params(
            lm_model.init_params(get_arch("falcon_mamba_7b").reduced(),
                                 device="cpu"), q=1),
        "lm_init_params": lambda: lm_model.init_params(
            get_arch("falcon_mamba_7b").reduced()),
        "serve_dense": lambda: serve("gemma3_4b", batch=1, prompt_len=2,
                                     gen_tokens=1),
        "lm_init_params_dense": lambda: lm_model.init_params(
            get_arch("gemma3_4b").reduced()),
        "lm_init_cache_dense": lambda: lm_model.init_cache(
            Runtime(), get_arch("gemma3_4b").reduced(), 1, 4),
        "run_delayed_fused": lambda: staleness.run_delayed_fused(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), 1, 1, 0.1, 2),
        "run_delayed_multi_fused": lambda: staleness.run_delayed_multi_fused(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), 1, 1, 0.1, 2),
        "init_state": lambda: staleness.init_state(4, 1),
        "train_deep": lambda: algorithms.train(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1, deep=True),
        "train_deep_fused": lambda: algorithms.train(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1, deep=True,
            engine="fused"),
        "train_deep_vfl": lambda: deep_vfl.train_deep_vfl(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1),
        "train_centralized": lambda: deep_vfl.train_centralized(
            losses.ridge(), x, np.ones(6, np.float32),
            algorithms.PartyLayout.even(4, 2, 1), epochs=1),
        "run_faulted_fused": lambda: faults.run_faulted_fused(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2),
        "run_guarded_fused": lambda: faults.run_guarded_fused(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2),
        "run_faulted_reference": lambda: faults.run_faulted_reference(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2),
        "run_guarded_reference": lambda: faults.run_guarded_reference(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2),
        "train_supervised": lambda: algorithms.train(
            losses.ridge(), x, np.ones(6, np.float32), lay, epochs=1,
            supervise=True, checkpoint_dir=ck),
        "supervised_train": lambda: supervisor.supervised_train(
            losses.ridge(), x, np.ones(6, np.float32), lay, epochs=1,
            checkpoint_dir=ck),
        "supervised_guarded_run": lambda: supervisor.supervised_guarded_run(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2, checkpoint_dir=ck),
        "run_deep_faulted_fused": lambda: faults.run_deep_faulted_fused(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2),
        "run_deep_guarded_fused": lambda: faults.run_deep_guarded_fused(
            losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
            0.1, 2),
        "run_deep_faulted_reference":
            lambda: faults.run_deep_faulted_reference(
                losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
                0.1, 2),
        "run_deep_guarded_reference":
            lambda: faults.run_deep_guarded_reference(
                losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
                0.1, 2),
        "supervised_guarded_run_deep":
            lambda: supervisor.supervised_guarded_run(
                losses.ridge(), x, np.ones(6, np.float32), lay, trace, 1, 1,
                0.1, 2, deep=True, checkpoint_dir=ck),
        "FusedEngine_mesh": lambda: engine.FusedEngine(
            losses.ridge(), x, np.ones(6, np.float32), lay,
            mesh=PartyMesh(q=2, slots=1, data_shards=2)),
        "ServeEngine_mesh": lambda: ServeEngine(engine.FusedEngine(
            losses.ridge(), x, np.ones(6, np.float32), lay,
            mesh=PartyMesh(q=2, slots=1, data_shards=2), device="cpu")),
        "run_async": lambda: async_engine.run_async(
            losses.ridge(), x, np.ones(6, np.float32), lay, batch=2,
            total_epochs=1.0),
        "run_sync": lambda: async_engine.run_sync(
            losses.ridge(), x, np.ones(6, np.float32), lay, batch=2,
            total_epochs=1.0),
        "analysis_main": lambda: lint_runner.main(["--quick"]),
        "analyze_matrix": lambda: lint_entrypoints.analyze_matrix(
            ("off",), ("sgd",)),
        "lint_mesh_run": lambda: lint_mesh.run(quick=True),
        "lint_mesh_spawn": lambda: lint_mesh.spawn(lint_mesh.lint_world,
                                                   {"flat": 4}),
        "lint_mesh_start": lambda: lint_mesh.start(lint_mesh.lint_world,
                                                   {"flat": 4}),
        "lm_train": lambda: lm_train.train("falcon_mamba_7b", 1, 1, 4, 1e-3),
        "lm_make_train_batch": lambda: make_batch(
            get_arch("falcon_mamba_7b").reduced(),
            ShapeConfig("t", 4, 1, "train"), Runtime()),
        # models/moe.py takes tensors and a generator and follows their
        # device; the MoE family's card-defaulting entry points are these
        "serve_granite_moe": lambda: serve("granite_moe_1b_a400m", batch=1,
                                           prompt_len=2, gen_tokens=1),
        "serve_qwen3_moe": lambda: serve("qwen3_moe_30b_a3b", batch=1,
                                         prompt_len=2, gen_tokens=1),
        "lm_init_params_moe": lambda: lm_model.init_params(
            get_arch("qwen3_moe_30b_a3b").reduced()),
        "lm_init_cache_moe": lambda: lm_model.init_cache(
            Runtime(), get_arch("granite_moe_1b_a400m").reduced(), 1, 4),
        "lm_params_moe": lambda: convert.lm_params(
            lm_model.init_params(get_arch("granite_moe_1b_a400m").reduced(),
                                 device="cpu"), q=1),
        "lm_train_moe": lambda: lm_train.train("granite_moe_1b_a400m", 1, 1,
                                               4, 1e-3),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""           # no card, even where one is
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    script = shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, script)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
