"""The port's LM training infrastructure: the cosine schedule, gradient
compression, the synthetic token stream, checkpoints and the trainer CLI.

* ``cosine_warmup_schedule`` equals the JAX schedule evaluated op by op
  (eagerly) at every step; inside JAX's jitted train step XLA folds the
  division and the cosine differently, by an ulp or two, which
  ``test_torch_lm_train.py`` allows for.
* Compression equals JAX's bit for bit on the same gradients (q, scale,
  residual).
* ``SyntheticTokens`` cannot draw JAX's threefry numbers, so its draws are
  checked by their statistics: the repeat rate within 0.02 of 0.3 (its
  standard error at this size is 0.0007) and the unigram counts against the
  Zipf law by a chi-square statistic below its degrees of freedom plus six
  standard deviations.
* The trainer runs on the CPU (``--device cpu``): its loss falls, a resumed
  run is bit-exact against a straight one (as
  ``tests/launch/test_trainer.py``), SIGTERM checkpoints and exits 0, and
  the straggler watchdog forces checkpoints; ``chip_smoke.py`` phase 32's
  comparison runs here on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jax_compression
from repro.optim.schedules import cosine_warmup_schedule as jax_cosine
from repro_torch.data.pipeline import REPEAT_P, DataConfig, SyntheticTokens
from repro_torch.distributed import compression
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.train_step import TrainState
from repro_torch.launch import train
from repro_torch.optim import AdamWState, cosine_warmup_schedule

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# schedule and compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "args", [(3e-4, 100, 200), (1e-3, 100, 50), (1e-3, 5, 30), (1e-3, 0, 7), (2e-4, 10, 10)],
    ids=["trainer_defaults", "test_trainer", "short_warmup", "no_warmup", "warmup_is_total"],
)
def test_cosine_warmup_schedule_equals_jax_at_every_step(args):
    ours, theirs = cosine_warmup_schedule(*args), jax_cosine(*args)
    for step in range(args[2] + 3):
        want = np.float32(theirs(jnp.int32(step)))
        assert np.float32(ours(step)) == want, step


def _grad_tree(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((17, 9)) * 3).astype(np.float32),
        "b": rng.standard_normal(9).astype(np.float32) * 1e-3,
        "zeros": np.zeros(5, np.float32),
        "ties": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32),  # half-way cases of round
    }


def test_compression_equals_jax_bit_for_bit():
    for name, x in _grad_tree(0).items():
        q, scale = compression.quantize_int8(torch.from_numpy(x))
        jq, jscale = jax_compression.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq)), name
        assert scale.item() == float(jscale), name
        deq = compression.dequantize_int8(q, scale)
        assert np.array_equal(deq.numpy(), np.asarray(jax_compression.dequantize_int8(jq, jscale))), name

    ef = {k: np.zeros_like(v) for k, v in _grad_tree(0).items()}
    tef = {k: torch.from_numpy(v) for k, v in ef.items()}
    for rnd in range(3):  # the residual feeds the next round
        grads = _grad_tree(rnd + 1)
        jg, ef = jax_compression.compress_decompress_with_feedback(
            {k: jnp.asarray(v) for k, v in grads.items()}, {k: jnp.asarray(v) for k, v in ef.items()}
        )
        tg, tef = compression.compress_decompress_with_feedback({k: torch.from_numpy(v) for k, v in grads.items()}, tef)
        for k in grads:
            assert np.array_equal(tg[k].numpy(), np.asarray(jg[k])), (rnd, k)
            assert np.array_equal(tef[k].numpy(), np.asarray(ef[k])), (rnd, k)
            assert tef[k].dtype == torch.float32


def test_compression_keeps_the_gradient_dtype():
    g = {"w": torch.randn(4, 4, generator=torch.Generator().manual_seed(0)).bfloat16()}
    out, ef = compression.compress_decompress_with_feedback(g, {"w": torch.zeros(4, 4)})
    assert out["w"].dtype == torch.bfloat16 and ef["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the synthetic token stream
# ---------------------------------------------------------------------------
def test_synthetic_tokens_are_deterministic_shaped_and_shifted():
    data = SyntheticTokens(DataConfig(vocab=128, batch=4, seq_len=16, seed=7))
    b1, b2 = data.batch(5), data.batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    assert b1["tokens"].shape == b1["labels"].shape == (4, 16)
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])  # labels are next-token
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 128
    assert not torch.equal(b1["tokens"], data.batch(6)["tokens"])
    other_seed = SyntheticTokens(DataConfig(vocab=128, batch=4, seq_len=16, seed=8))
    assert not torch.equal(b1["tokens"], other_seed.batch(5)["tokens"])
    frames = data.frames(5, 3, 8)
    assert frames.shape == (4, 3, 8) and frames.dtype == torch.float32
    assert torch.equal(frames, data.frames(5, 3, 8))


def test_synthetic_tokens_repeat_rate_and_zipf_unigrams():
    cfg = DataConfig(vocab=4096, batch=64, seq_len=1023)
    data = SyntheticTokens(cfg)
    bases, reps = zip(*(data._draws(i) for i in range(8)))
    rep = torch.cat(reps)
    assert abs(float(rep.double().mean()) - REPEAT_P) < 0.02

    # a repeated token is the previous draw plus one; the rest are the draws
    base = torch.cat(bases)
    stream = torch.cat([torch.cat([data.batch(i)["tokens"], data.batch(i)["labels"][:, -1:]], 1) for i in range(8)])
    want = torch.where(rep, (torch.roll(base, 1, 1) + 1) % cfg.vocab, base)
    assert torch.equal(stream.long(), want)

    counts = np.bincount(base.flatten().numpy(), minlength=cfg.vocab).astype(np.float64)
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    expected = ranks**-cfg.zipf_a / (ranks**-cfg.zipf_a).sum() * counts.sum()
    keep = expected >= 5  # pool the tail so every cell expects at least 5
    obs, exp = counts[keep], expected[keep]
    if not keep.all():
        obs, exp = np.append(obs, counts[~keep].sum()), np.append(exp, expected[~keep].sum())
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    dof = len(obs) - 1
    assert chi2 < dof + 6 * np.sqrt(2 * dof), (chi2, dof)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state(seed: int) -> TrainState:
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(6, 4, generator=g), "norm": torch.randn(4, generator=g).bfloat16()}
    moments = lambda: {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    return TrainState(params=params, opt=AdamWState(step=seed, mu=moments(), nu=moments()), error_feedback={})


def _assert_states_equal(a: TrainState, b: TrainState) -> None:
    assert a.opt.step == b.opt.step and isinstance(b.opt.step, int)
    for x, y in ((a.params, b.params), (a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu)):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k


def test_checkpoint_round_trip_keeps_layout_and_bf16_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    state = _state(3)
    mgr.save(7, state, extras={"step": 7, "loss": 1.25})
    restored, extras = mgr.restore(_state(0))
    _assert_states_equal(state, restored)
    assert extras == {"step": 7, "loss": 1.25}
    step_dir = tmp_path / "ck" / "step_0000000007"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["step"] == 7
    leaf = manifest["leaves"][".params['norm']"]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [4]
    raw = np.load(step_dir / leaf["file"])
    assert raw.dtype == np.uint16  # bf16 as its bits: no ml_dtypes needed
    assert np.array_equal(raw, state.params["norm"].view(torch.int16).numpy().view(np.uint16))
    assert sorted(p.name for p in step_dir.iterdir()) == [f"leaf_{i:05d}.npy" for i in range(7)] + ["manifest.json"]


def test_checkpoint_rotation_keeps_the_last_k_and_leaves_no_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 6):
        mgr.save(step, _state(step), blocking=step % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert not list(tmp_path.glob("*.tmp"))
    restored, _ = mgr.restore(_state(0), step=4)
    _assert_states_equal(_state(4), restored)


def test_async_save_writes_the_values_at_the_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(2)
    before = _state(2)
    mgr.save(1, state, blocking=False)
    with torch.no_grad():  # the trainer updates in place right after a save
        for t in (*state.params.values(), *state.opt.mu.values()):
            t.add_(1.0)
    restored, _ = mgr.restore(_state(0))
    _assert_states_equal(before, restored)


def test_a_crash_mid_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    calls = {"n": 0}
    real_save = np.save

    def failing_save(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk full")
        return real_save(*args, **kwargs)

    monkeypatch.setattr(np, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, _state(2))
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(_state(0))
    _assert_states_equal(_state(1), restored)
    mgr.save(2, _state(2))  # the leftover .tmp is replaced
    assert mgr.all_steps() == [1, 2] and not list(tmp_path.glob("*.tmp"))


def test_restore_raises_without_a_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0))
    mgr.save(1, _state(1))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0), step=2)
    with pytest.raises(ValueError, match="template"):
        mgr.restore(dataclasses.replace(_state(0), params={"embed": torch.zeros(3), "norm": torch.zeros(4).bfloat16()}))


# ---------------------------------------------------------------------------
# the trainer CLI
# ---------------------------------------------------------------------------
SMOKE = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--batch", "4", "--seq-len", "32"]


def _losses(out: str) -> list[float]:
    return [float(m) for m in re.findall(r"^step +\d+ loss (\S+)", out, re.M)]


def test_trainer_loss_falls_over_30_steps(tmp_path, capsys):
    final = train.main(SMOKE + ["--steps", "30", "--log-every", "1", "--lr", "1e-3", "--ckpt-dir", str(tmp_path)])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert abs(final - losses[-1]) < 1e-4
    assert CheckpointManager(str(tmp_path)).latest_step() == 30


def _leaves(ckpt: Path, step: int) -> dict[str, bytes]:
    path = ckpt / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    return {k: (path / v["file"]).read_bytes() for k, v in manifest["leaves"].items()}


def test_trainer_resume_is_bit_exact(tmp_path, capsys):
    _resume_is_bit_exact(SMOKE, tmp_path, capsys)


@pytest.mark.parametrize(
    "arch,key", [("gemma2-9b", "layers.1.global.attn.q_proj"), ("granite-moe-3b-a800m", "layers.1.moe.router"),
                 ("whisper-base", "dec_layers.1.cross.k_proj")],
)
def test_trainer_resume_is_bit_exact_for_pairs_experts_and_encdec(arch, key, tmp_path, capsys):
    """The checkpoint keys of gemma2's pairs, the experts and whisper's two
    stacks (``.params['layers.1.global.attn.q_proj']``, ...) round-trip."""
    args = ["--arch", arch] + SMOKE[2:]
    _resume_is_bit_exact(args, tmp_path, capsys)
    manifest = json.loads((tmp_path / "a" / "step_0000000006" / "manifest.json").read_text())
    assert f".params['{key}']" in manifest["leaves"] and f".opt.mu['{key}']" in manifest["leaves"]


def _resume_is_bit_exact(args: list[str], tmp_path, capsys) -> None:
    common = args + ["--ckpt-every", "3", "--log-every", "1"]
    straight = train.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    direct = _losses(capsys.readouterr().out)
    train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    resumed = train.main(common + ["--steps", "6", "--resume", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[resume] from step 3" in out
    assert _losses(out) == direct[3:] and resumed == straight
    assert _leaves(tmp_path / "a", 6) == _leaves(tmp_path / "b", 6)


def test_trainer_watchdog_forces_checkpoints(tmp_path, capsys):
    train.main(SMOKE + ["--steps", "8", "--ckpt-every", "100", "--straggler-factor", "0",
                        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("[watchdog]") == 3  # steps 5, 6 and 7: once 6 steps have set the median
    assert CheckpointManager(str(tmp_path)).all_steps() == [6, 7, 8]


def test_trainer_sigterm_checkpoints_and_exits_0(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *SMOKE, "--steps", "100000",
           "--log-every", "1", "--ckpt-every", "1000", "--ckpt-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step "):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines) + out
    assert proc.returncode == 0, out
    assert "[preempt] SIGTERM received" in out
    steps = CheckpointManager(str(tmp_path)).all_steps()
    assert len(steps) == 1 and 1 <= steps[0] < 100000


def test_trainer_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])


def test_chip_smoke_phase_32_on_the_cpu(tmp_path):
    """What ``chip_smoke.py`` phase 32 compares on the card, run here with
    ``--device cpu``: a straight run against a resumed one (losses of steps
    3-5 and the final leaves bit-identical) and a SIGTERM run."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = chip_smoke.trainer_resume_and_preempt("cpu", tmp_path)
    assert len(out["losses_steps_3_5"]) == 3 and out["leaves"] > 0 and out["sigterm_checkpoints"]
