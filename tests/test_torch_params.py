"""The port's parameters equal the JAX package's exactly, and the port stands
alone: it imports nothing of JAX or of the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ChargaxEnv as JaxEnv
from repro.core import EnvConfig as JaxConfig
from repro.core import station as jax_station
from repro.core.state import EnvParams as JaxParams
from repro_torch import convert
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core.state import EnvParams
from repro_torch.rl import evaluate, max_charge_policy, serve

ROOT = Path(__file__).resolve().parents[1]


def _assert_params_equal(tp: EnvParams, jp: JaxParams):
    for f in dataclasses.fields(JaxParams):
        if f.name == "pole":
            continue
        want, got = getattr(jp, f.name), getattr(tp, f.name)
        if f.name == "weights":
            for w in dataclasses.fields(want):
                assert float(getattr(got, w.name)) == float(getattr(want, w.name)), w.name
            continue
        assert got.dtype == torch.float32, f.name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)


@pytest.mark.parametrize("architecture", sorted(jax_station.ARCHITECTURES))
def test_make_params_matches_jax(architecture):
    jenv = JaxEnv(JaxConfig(architecture=architecture))
    tenv = ChargaxEnv(EnvConfig(architecture=architecture), device="cpu")
    _assert_params_equal(tenv.make_params(), jenv.make_params())
    assert tenv.obs_dim == jenv.obs_dim
    assert tenv.action_space.shape == jenv.action_space.shape
    assert tenv.num_actions_per_head == jenv.num_actions_per_head


@pytest.mark.parametrize(
    "config",
    [
        dict(price_region="DE", price_year=2022),
        dict(scenario="work", traffic="high", car_region="US"),
        dict(battery=False, dt_minutes=15.0),
        dict(architecture="kiosk_ac_4", pad_evse=8, pad_nodes=3),
    ],
    ids=["prices", "profile", "no_battery_dt15", "padded"],
)
def test_make_params_matches_jax_for_other_datasets(config):
    jenv, tenv = JaxEnv(JaxConfig(**config)), ChargaxEnv(EnvConfig(**config), device="cpu")
    _assert_params_equal(tenv.make_params(), jenv.make_params())


def test_make_params_overrides_match_jax():
    jenv, tenv = JaxEnv(JaxConfig()), ChargaxEnv(EnvConfig(), device="cpu")
    kw = dict(price_year=2023, traffic=90.0, profile="highway", price_region="FR",
              car_region="World")
    _assert_params_equal(tenv.make_params(**kw), jenv.make_params(**kw))


def test_spaces_describe_obs_and_actions():
    tenv = ChargaxEnv(EnvConfig(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    obs, _ = tenv.reset(gen, num_envs=3)
    assert all(tenv.observation_space.contains(row) for row in obs.numpy())
    assert not tenv.observation_space.contains(obs.numpy())  # batched: wrong shape
    space = tenv.action_space
    assert space.shape == (17,) and space.num_categories == 21
    assert space.contains(np.full(17, 20, np.int32))
    assert not space.contains(np.full(17, 21, np.int32))
    assert not space.contains(np.full(17, 1.0))


def test_env_params_from_numpy_round_trips_jax_params():
    jp = JaxEnv(JaxConfig()).default_params
    fields = {
        f.name: getattr(jp, f.name) for f in dataclasses.fields(JaxParams) if f.name != "pole"
    }
    fields["weights"] = {
        f.name: getattr(jp.weights, f.name) for f in dataclasses.fields(jp.weights)
    }
    _assert_params_equal(convert.env_params_from_numpy(fields, device="cpu"), jp)


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------
def _port_files() -> list[Path]:
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChargaxEnv(EnvConfig())
    env = ChargaxEnv(EnvConfig(episode_hours=0.25), device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(env, max_charge_policy(env), None, gen, num_episodes=2)
    obs = torch.zeros((2, env.obs_dim))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(max_charge_policy(env), None, obs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.env_state_from_numpy({})
    assert serve(max_charge_policy(env), None, obs, device="cpu").shape == (2, 17)
    assert evaluate(env, max_charge_policy(env), None, gen, num_episodes=2, device="cpu")
