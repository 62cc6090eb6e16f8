"""The port's language-model serving against the reference's, on the CPU.

* ``generate``: 8 greedy tokens after an 8-token prompt (numpy seed), on
  the reference's parameters carried across, in float32 compute with the
  default bfloat16 caches, equal the reference's ``generate`` token for
  token, for every token-input architecture at its reduced config.
* Temperature sampling draws from a seeded ``torch.Generator``: the same
  seed gives the same tokens, every token lies in the vocabulary (its
  draws differ from ``jax.random.categorical``'s, so they are not held
  to the reference's).
* The stub frontends (patches, frames) are refused, as the reference's
  ``generate`` serves only tokens.
* ``serve --arch ... --reduced --device cpu`` serves: its sequences equal
  ``generate`` on ``init_params`` of seed 0 and prompts of seed 1.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402

TOKEN_ARCHS = [a for a in list_archs()
               if get_config(a, reduced=True).frontend is None]
PROMPT, GEN = 8, 8


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_generate_equals_the_reference(arch):
    rcfg = dataclasses.replace(ref_config(arch, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    rp = jax.tree.map(np.asarray, jax.jit(functools.partial(
        RM.init_params, rcfg))(jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    max_seq = PROMPT + GEN + 8
    want = ref_serve.generate(rcfg, rp, jnp.asarray(prompts), GEN, max_seq)
    got = serve.generate(cfg, params_from_numpy(rp, device="cpu"),
                         torch.tensor(prompts), GEN, max_seq)
    assert got.dtype == torch.int32 and got.shape == (2, PROMPT + GEN)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_is_seeded():
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (3, 5), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    runs = [serve.generate(cfg, params, prompts, 6, 20, temperature=1.5,
                           seed=seed) for seed in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    for r in runs:
        assert torch.equal(r[:, :5], prompts)
        assert int(r.min()) >= 0 and int(r.max()) < cfg.vocab


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_generate_refuses_the_stub_frontends(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(ValueError, match="token-input"):
        serve.generate(cfg, {}, torch.zeros((1, 4), dtype=torch.int32), 2, 8)


def test_serve_cli_lm_mode_on_the_cpu(capsys):
    seqs = serve.main(["--arch", "qwen3-0.6b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    cfg = get_config("qwen3-0.6b", reduced=True)
    prompts = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    want = serve.generate(
        cfg, init_params(cfg, torch.Generator().manual_seed(0)), prompts, 4,
        20)
    assert torch.equal(seqs, want)
    out = capsys.readouterr().out
    assert "[serve] qwen3-0.6b: batch=2 prompt=8 gen=4 on cpu" in out
    assert "[serve] first sequence:" in out
