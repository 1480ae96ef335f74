"""The model's decode over a zoned cache (``ServeModel.admit`` and
``decode_sessions``, ``decode_step`` with per-row positions) on the CPU, at
granite-8b's ``reduced()`` size in float32, weights from the JAX package.

At equal positions it must give the dense decode's logits (``generate``'s
path) within the bound ``tests/test_torch_serve_step.py`` holds granite-8b
to; at ragged positions, sessions prefilled, admitted, decoded, evicted and
replaced must give, every step, the JAX package's forward pass over each
session's prompt plus its tokens at that position. Kinds the zoned cache
does not serve are refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as r_forward
from repro_torch.configs import get_reduced
from repro_torch.models import cache_specs, decode_step, init_params
from repro_torch.models.params import load_reference_params
from repro_torch.serve import KVZoneCache, ServeModel
from test_torch_serve_step import TOL, f32_configs, f32_reference_params, f32_specs
from repro_torch import _tree

ARCH = "granite-8b"


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = f32_configs(ARCH)
    ref = f32_reference_params(rcfg)
    return rcfg, ref, ServeModel(pcfg, load_reference_params(pcfg, ref, "cpu",
                                                             specs=f32_specs(pcfg)),
                                 device="cpu")


def zoned_cache(cfg, num_zones=32, zone_len=4, max_zones=8):
    return KVZoneCache(num_layers=cfg.num_layers, num_zones=num_zones, zone_len=zone_len,
                       kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       max_zones_per_seq=max_zones, dtype=torch.float32, device="cpu")


def test_zoned_decode_matches_the_dense_decode_at_equal_positions(model):
    _, _, m = model
    cfg = m.cfg
    B, L, N = 2, 11, 6
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, L + N)))
    batch = {"tokens": toks[:, :L]}
    last, prefix = m.prefill(batch)
    dense = init_params(cache_specs(cfg, B, L + N), 0, "cpu")
    _tree.tree_map(lambda p, f: f[tuple(slice(0, s) for s in p.shape)].copy_(p), prefix, dense)
    zc = zoned_cache(cfg)
    zoned_last = m.admit(zc, [3, 9], batch)
    assert torch.equal(zoned_last, last)
    for t in range(N):
        tok = toks[:, L + t:L + t + 1]
        want, dense = decode_step(cfg, m.tree(), dense, tok, L + t)
        nxt, got = m.decode_sessions(zc, [3, 9], tok)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL[ARCH], atol=TOL[ARCH])
        assert torch.equal(nxt[:, 0], torch.argmax(got, -1).to(torch.int32))


def test_ragged_sessions_follow_the_reference_forward(model):
    """Three rows at their own positions; after step 3 the row of session 1
    is evicted and session 5, another prompt, takes it."""
    rcfg, ref, m = model
    cfg = m.cfg
    rng = np.random.default_rng(6)
    prompts = {0: 9, 1: 5, 2: 14, 5: 7}
    seqs = {k: rng.integers(0, cfg.vocab_size, n + 8) for k, n in prompts.items()}
    zc = zoned_cache(cfg)
    for k in (0, 1, 2):
        m.admit(zc, [k], {"tokens": torch.from_numpy(seqs[k][None, :prompts[k]])})
    done = {k: 0 for k in prompts}
    rows = [0, 1, 2]
    ref_logits = jax.jit(lambda p, t: r_forward(rcfg, p, {"tokens": t})[0])
    for step in range(7):
        evict, admit = (), ()
        if step == 4:
            _, k, v = m.prompt_kv({"tokens": torch.from_numpy(seqs[5][None, :prompts[5]])})
            evict, admit, rows = (1,), ((5, k[:, 0], v[:, 0]),), [0, 5, 2]
        tok = torch.tensor([[seqs[k][prompts[k] + done[k]]] for k in rows])
        _, got = m.decode_sessions(zc, rows, tok, evict=evict, admit=admit)
        for b, k in enumerate(rows):
            n = prompts[k] + done[k] + 1
            want = ref_logits(ref, jnp.asarray(seqs[k][None, :n], jnp.int32))
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want[0, -1]),
                                       rtol=TOL[ARCH], atol=TOL[ARCH])
            done[k] += 1
    assert 1 not in zc._seqs and zc._seqs[5].length == prompts[5] + 3


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m", "recurrentgemma-9b"])
def test_kinds_the_zones_do_not_serve_are_refused(arch):
    cfg = get_reduced(arch)
    m = ServeModel(cfg, init_params(f32_specs(cfg), 0, "cpu"), device="cpu")
    zc = zoned_cache(cfg) if cfg.num_kv_heads else None
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="zoned cache"):
        m.admit(zc, [0], {"tokens": tokens})
    with pytest.raises(ValueError, match="zoned cache"):
        decode_step(cfg, m.tree(), None, tokens[:, :1], torch.zeros(1, dtype=torch.int32))
