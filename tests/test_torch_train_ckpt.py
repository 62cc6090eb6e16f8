"""The port's checkpoints, fault-tolerant runner and training launcher on
the CPU, mirroring ``tests/test_distributed.py`` and
``tests/test_system.py::test_lm_train_crash_resume_serve``.

* ``Checkpointer``: a round trip (bfloat16 and int32 leaves included),
  gc down to ``keep`` and the latest step, ``.tmp`` directories ignored,
  leaves restored onto their template's device and dtype.
* Across the packages: a checkpoint the reference writes of its
  (params, AdamW state) at qwen3-0.6b reduced restores in the port equal
  to the same state carried across, and one the port writes restores in
  the reference (the leaves in ``jax.tree_util``'s order on both sides).
* ``TrainingRunner``: a crash at step 7 and a resume give the
  uninterrupted run's state bit for bit; the straggler watchdog flags a
  slow step and keeps it out of its EMA.
* ``quantize_int8``'s error feedback recovers the mean gradient;
  ``adamw_update`` with bfloat16 moments converges on w².
* ``launch.train``: ``build`` + the runner with a crash at step 4 and a
  resume run exactly the missing steps with the uninterrupted run's
  losses bit for bit; ``main(... --device cpu)`` prints the reference's
  ``[train]`` line and returns the losses; ``--model-parallel 2`` in one
  process is refused (it must divide the process count); then the crash-resume-serve path of
  ``tests/test_system.py`` through the port (smaller), and the training
  example for 3 steps.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train_loss import leaves, ref_params  # noqa: E402

from repro.distributed import checkpoint as ref_checkpoint  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import batch_for_step  # noqa: E402
from repro_torch.distributed.checkpoint import Checkpointer  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    StragglerPolicy, TrainingRunner)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.models.model import init_params, tree_map  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         adamw_update, init_opt_state)
from repro_torch.train.train_step import (make_train_step,  # noqa: E402
                                          quantize_int8)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _toy_state():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "b": torch.ones((4,), dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}


def _assert_trees_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                              want[k]), k


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _toy_state()
    ck.save(10, state, blocking=True)
    restored, step = ck.restore(tree_map(torch.zeros_like, state))
    assert step == 10
    _assert_trees_equal(restored, state)
    manifest = (tmp_path / "step_00000010" / "manifest.json").read_text()
    assert '"n_leaves": 3' in manifest


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _toy_state())          # async: each save waits for the last
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_tmp_dir_ignored(tmp_path):
    """A crashed mid-write .tmp dir must not be seen as a checkpoint."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _toy_state(), blocking=True)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ck.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(_toy_state())


def test_save_copies_before_the_writer_runs(tmp_path):
    """The writer thread reads host copies taken in ``save``: changing the
    state in place right after ``save`` returns does not reach the file."""
    ck = Checkpointer(str(tmp_path))
    state = _toy_state()
    ck.save(1, state)
    state["w"].add_(100.0)
    ck.wait()
    restored, _ = ck.restore(tree_map(torch.zeros_like, state))
    assert torch.equal(restored["w"], torch.arange(12.0).reshape(3, 4))


@functools.lru_cache(maxsize=None)
def _carried_state():
    """(params, AdamW state) of qwen3-0.6b reduced after one reference
    step, as numpy."""
    opt = ref_opt.AdamWConfig()
    p = jax.tree.map(jnp.asarray, ref_params("qwen3-0.6b"))
    o = ref_opt.init_opt_state(opt, p)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), p)
    p, o = jax.jit(functools.partial(ref_opt.adamw_update, opt))(p, g, o)
    return jax.tree.map(np.asarray, (p, o))


def _port_tree(np_state):
    p, o = np_state

    def bf16(tree):            # numpy has no bfloat16 of torch's
        return params_from_numpy(jax.tree.map(
            lambda a: a.astype(np.float32), tree), device=CPU,
            dtype=torch.bfloat16)
    return (params_from_numpy(p, device=CPU),
            {"m": bf16(o["m"]), "v": bf16(o["v"]),
             "step": torch.tensor(o["step"])})


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _carried_state()
    ref_checkpoint.Checkpointer(str(tmp_path)).save(
        1, jax.tree.map(jnp.asarray, state), blocking=True)
    want = _port_tree(state)
    assert want[1]["m"]["embed"].dtype == torch.bfloat16
    got, step = Checkpointer(str(tmp_path)).restore(
        tree_map(torch.zeros_like, want))
    assert step == 1
    _assert_trees_equal(got, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _carried_state()
    Checkpointer(str(tmp_path)).save(2, _port_tree(state), blocking=True)
    template = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, state))
    got, step = ref_checkpoint.Checkpointer(str(tmp_path)).restore(template)
    assert step == 2
    got = jax.tree_util.tree_leaves(got)
    want = jax.tree_util.tree_leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def _runner(path):
    def step_fn(state, batch):
        w = state["w"] - 0.1 * batch["g"]
        return {"w": w}, {"loss": torch.sum(w ** 2)}

    def data_fn(step):        # a pure function of step
        return {"g": torch.randn(3, generator=torch.Generator()
                                 .manual_seed(step))}

    return TrainingRunner(step_fn, data_fn, Checkpointer(str(path)),
                          ckpt_every=4)


def test_fault_tolerant_restart_is_bitexact(tmp_path):
    init = {"w": torch.ones(3)}
    golden, _ = _runner(tmp_path / "a").run(init, 10)
    with pytest.raises(RuntimeError, match="injected failure"):
        _runner(tmp_path / "b").run(init, 10, fail_at=7)
    resumed, hist = _runner(tmp_path / "b").run(init, 10)
    assert len(hist) == 6          # resumed from the step-4 checkpoint
    assert torch.equal(golden["w"], resumed["w"])


def test_straggler_watchdog_flags_slow_steps():
    pol = StragglerPolicy(threshold=2.0, grace_steps=1)
    for s in range(8):
        pol.observe(s, 0.1)
    assert not pol.flagged
    pol.observe(8, 0.5)      # 5x the EMA
    assert pol.flagged and pol.flagged[0][0] == 8
    assert abs(pol._ema - 0.1) < 1e-6


def test_int8_gradient_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=(256,)) * 0.01, dtype=torch.float32)
    err = torch.zeros_like(g)
    acc_plain = torch.zeros_like(g)
    acc_fb = torch.zeros_like(g)
    for _ in range(50):
        acc_plain += quantize_int8(g, torch.zeros_like(g))[0]
        q2, err = quantize_int8(g, err)
        acc_fb += q2
    err_plain = float((acc_plain / 50 - g).abs().max())
    err_fb = float((acc_fb / 50 - g).abs().max())
    assert err_fb < err_plain * 0.5 or err_fb < 1e-5


def test_adamw_bf16_states_converge():
    opt = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, state_dtype="bfloat16")
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = init_opt_state(opt, params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}      # d/dw of w^2
        params, state = adamw_update(opt, params, grads, state)
    assert float(params["w"].abs().max()) < 0.15
    assert state["m"]["w"].dtype == torch.bfloat16


def _build(**kw):
    return train.build("qwen3-0.6b", reduced=True, batch=4, seq=16,
                       steps=6, device="cpu", **kw)


def test_build_crash_and_resume_replay_the_losses(tmp_path):
    _, mesh, state, step_fn, data_fn = _build()
    assert mesh.shape == {"data": 1, "model": 1}
    golden = TrainingRunner(step_fn, data_fn,
                            Checkpointer(str(tmp_path / "a")),
                            ckpt_every=3).run(state, 6)[1]
    with pytest.raises(RuntimeError, match="injected failure"):
        TrainingRunner(step_fn, data_fn, Checkpointer(str(tmp_path / "b")),
                       ckpt_every=3).run(state, 6, fail_at=4)
    _, hist = TrainingRunner(step_fn, data_fn,
                             Checkpointer(str(tmp_path / "b")),
                             ckpt_every=3).run(_build()[2], 6)
    assert len(hist) == 3
    assert [h["loss"] for h in hist] == [h["loss"] for h in golden[3:]]
    assert [h["step"] for h in hist] == [4.0, 5.0, 6.0]


def test_train_main_on_the_cpu(tmp_path, capsys):
    losses = train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps",
                         "3", "--batch", "2", "--seq", "16", "--device",
                         "cpu", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2", "--n-micro", "2",
                         "--compress-grads", "--remat", "full"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert f"[train] qwen3-0.6b steps=3 loss {losses[0]:.3f} -> " in out
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    with pytest.raises(ValueError, match="must divide the 1 process"):
        train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                    "--model-parallel", "2", "--ckpt-dir", str(tmp_path)])


def test_lm_train_crash_resume_serve(tmp_path):
    """``tests/test_system.py``'s case at a third of its steps and a
    quarter of its batch (4 x 32 tokens, 12 steps, a checkpoint every 4,
    a crash at step 9), so that it stays cheap on a loaded CPU."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = AdamWConfig(lr=1e-3, total_steps=12, warmup_steps=2)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    opt_state = init_opt_state(opt, params)
    shape = ShapeConfig("t", 32, 4, "train")
    step = make_train_step(cfg, opt, remat="dots", n_micro=2)

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    def data_fn(s):
        return batch_for_step(cfg, shape, s, device=CPU)

    runner = TrainingRunner(step_fn, data_fn, Checkpointer(str(tmp_path)),
                            ckpt_every=4)
    with pytest.raises(RuntimeError, match="injected failure"):
        runner.run((params, opt_state), 12, fail_at=9)
    # resume from the step-8 checkpoint and finish: exactly 4 steps run
    runner2 = TrainingRunner(step_fn, data_fn, Checkpointer(str(tmp_path)),
                             ckpt_every=4)
    (params2, _), hist = runner2.run((params, opt_state), 12)
    assert len(hist) == 4, len(hist)
    assert all(np.isfinite(h["loss"]) for h in hist)

    # serve from the trained weights
    prompts = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    seqs = serve.generate(cfg, params2, prompts, gen_len=4, max_seq=16)
    assert seqs.shape == (2, 12)


def test_train_example_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "examples/torch_train_tiny_lm.py", "--device",
         "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK: loss" in out.stdout
