"""The fused elementwise kernels of the zoned decode step
(``kernels/decode_fused/csrc/decode_fused.cu``) on the card, at
granite-8b's widths (B = 64, d 4,096, H/KV/hd 32/8/128, d_ff 14,336) in
bfloat16 and float32, rows at ragged positions 0-4,095, against the model's
plain functions run on the card; then the graphed zoned step with the
kernels against the plain functions' eager step at granite-8b's depth.

Run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_decode_fused_card.py``; without a Hopper card every test
skips (the kernels have no CPU mode). No JAX in this file.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import decode_fused
from repro_torch.kernels.paged_attn.kernel import paged_attention_kernel
from repro_torch.models import init_params, param_specs
from repro_torch.models.common import apply_norm, rope, silu
from repro_torch.serve import KVZoneCache, ServeModel
from test_torch_decode_fused import RMS, THETA, plain_zoned_step, ragged_positions

B, D, H, KV, HD, FF = 64, 4096, 32, 8, 128, 14336
DTYPES = [torch.bfloat16, torch.float32]


def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper card: the fused kernels have no CPU mode")


def randn(*shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _gap(got, want):
    return float((got.float() - want.float()).abs().max())


def launched(wrapper, *args):
    before = wrapper.launches
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [B * FF, 4099])          # 16-byte packs, and one value a load
def test_swiglu_is_silu_times_up_bit_for_bit(dtype, n, record_property):
    card()
    gate = randn(n, dtype=dtype, seed=1, scale=4.0)
    up = randn(n, dtype=dtype, seed=2)
    got = launched(decode_fused.swiglu, gate, up)
    want = silu(gate) * up
    record_property("max_abs_err.swiglu", _gap(got, want))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [HD, 20])                # 16-byte packs, and one value a load
def test_rope_qk_is_rope_bit_for_bit(dtype, hd, record_property):
    card()
    q = randn(B, 1, H, hd, dtype=dtype, seed=3)
    k = randn(B, 1, KV, hd, dtype=dtype, seed=4)
    pos = ragged_positions(B, 5).cuda()
    got_q, got_k = launched(decode_fused.rope_qk, q[:, 0], k[:, 0],
                            *decode_fused.rope_table(pos, hd, THETA))
    want_q = rope(q, pos[:, None, None], THETA)[:, 0]
    want_k = rope(k, pos[:, None, None], THETA)[:, 0]
    record_property("max_abs_err.rope_qk", max(_gap(got_q, want_q), _gap(got_k, want_k)))
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_k, want_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale_dtype", DTYPES)
@pytest.mark.parametrize("d,residual", [(D, True), (D, False), (4100, True)])
def test_add_rmsnorm_is_the_add_and_apply_norm(dtype, scale_dtype, d, residual,
                                               record_property):
    """x' bit for bit; h within one bfloat16 step, or in float32 within a
    relative 1e-6 (about 8 ulps): the row's sum of squares adds in another
    order than PyTorch's mean, so it may differ in its last bits, and with it
    the row's rsqrt by an ulp or a few, which moves each float32 element of
    h by as much and, rarely, a bfloat16 element's rounding by one step."""
    card()
    x = randn(B, 1, d, dtype=dtype, seed=6)
    r = randn(B, 1, d, dtype=dtype, seed=7, scale=3.0) if residual else None
    scale = randn(d, dtype=scale_dtype, seed=8)
    got_x, got_h = launched(decode_fused.add_rmsnorm, x, r, scale)
    want_x = x + r if residual else x
    assert torch.equal(got_x, want_x)
    want = apply_norm(RMS, {"scale": scale}, want_x).float()
    gap = (got_h.float() - want).abs()
    record_property("max_abs_err.add_rmsnorm", float(gap.max()))
    if dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        assert (gap <= step).all()
    else:
        rel = (gap / want.abs().clamp(min=1e-30)).max().item()
        assert rel <= 1e-6, rel


def _granite_depth_model():
    """granite-8b's 36 layers at reduced widths, bf16, every matrix
    N(0, (0.02 x sqrt(4,096 / d))^2) and random norm scales near 1: the
    benchmark's init at these widths, under which 36 layers stay well
    conditioned (the port's ``fan_in`` init is not at depth)."""
    cfg = get_reduced("granite-8b").replace(num_layers=36, head_dim=64, num_heads=8,
                                            num_kv_heads=2, d_model=256, d_ff=512)
    m = ServeModel(cfg, init_params(param_specs(cfg), 3, "cuda"), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    for name, t in m.named_buffers():
        noise = torch.randn(t.shape, generator=g, device="cuda")
        t.copy_(1 + 0.1 * noise if name.endswith("scale") else 0.08 * noise)
    return cfg, m


@pytest.mark.cuda
def test_the_graphed_fused_step_replays_the_plain_eager_step():
    """12 steps of 3 ragged sessions through ``decode_sessions`` (one CUDA
    graph a step, the fused kernels inside), through an eviction and an
    admission, against the plain functions' eager step on a second cache,
    within ``test_the_graph_replays_the_eager_step``'s tolerance; and the
    fused launches counted on every replay."""
    card()
    cfg, m = _granite_depth_model()
    L = cfg.num_layers

    def new_cache():
        return KVZoneCache(num_layers=L, num_zones=64, zone_len=16, kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.head_dim, max_zones_per_seq=8, device="cuda")
    graphed, eager = new_cache(), new_cache()
    rng = np.random.default_rng(0)
    prompts = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
               for k, n in ((0, 37), (1, 16), (2, 50), (3, 21))}
    for c in (graphed, eager):
        for k in (0, 1, 2):
            m.admit(c, [k], {"tokens": prompts[k]})
    wrappers = (decode_fused.add_rmsnorm, decode_fused.rope_qk, decode_fused.swiglu,
                paged_attention_kernel)
    per_step = (2 * L + 1, L, L, L)
    rows = [0, 1, 2]
    for t in range(12):
        evict, admit = (), ()
        if t == 6:
            _, k, v = m.prompt_kv({"tokens": prompts[3]})
            evict, admit, rows = (1,), ((3, k[:, 0], v[:, 0]),), [0, 3, 2]
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).cuda()
        before = [w.launches for w in wrappers]
        _, got = m.decode_sessions(graphed, rows, tok, evict=evict, admit=copy.copy(admit))
        # the first step runs eagerly once before its graph is captured
        assert [w.launches - n for w, n in zip(wrappers, before)] == \
            [n * (2 if t == 0 else 1) for n in per_step]
        for sid in evict:
            eager.evict(sid)
        for sid, k, v in admit:
            eager.admit(sid, k, v)
        step = eager.reserve(rows)
        want = plain_zoned_step(cfg, m.tree(), step, tok)
        torch.testing.assert_close(got, want)          # bf16's default tolerance
    assert [m._graph.launches[w] for w in wrappers] == list(per_step)
    torch.testing.assert_close(graphed.k, eager.k)
    torch.testing.assert_close(graphed.v, eager.v)
