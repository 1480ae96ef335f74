"""The fused elementwise kernels of the zoned decode step
(``kernels/decode_fused``) on the CPU, where each wrapper takes its plain
version: those must be the model's own functions (``apply_norm`` with the
residual add, ``rope``, ``silu``) bit for bit, and the zoned step must
take them exactly where a configuration has an RMS norm without bias or a
gated SiLU MLP outside a parallel block, and the plain functions elsewhere,
with the plain step's logits and zones bit for bit either way.

``plain_zoned_step`` is the zoned step as the plain functions compose it
(``apply_norm``, ``rope`` inside the projections, ``_attn_block_rest``);
``test_torch_decode_fused_card.py`` holds the graphed step on the card to
it. No JAX in this file.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import decode_fused
from repro_torch.kernels.decode_fused import kernel as df_kernel
from repro_torch.models import attention as attn
from repro_torch.models import init_params, param_specs
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import apply_norm, cdtype, rope, silu
from repro_torch.serve import KVZoneCache, ServeModel

RMS = get_reduced("granite-8b")           # an RMS norm
THETA = 10000.0


def plain_zoned_attention(cfg, p, h, step, layer):
    """The zoned attention with ``rope`` inside the projections."""
    pos = step.positions[:, None]
    q = attn._project_q(cfg, p, h, pos)
    k, v = attn._project_kv(cfg, p, h, pos)
    step.write(layer, k[:, 0], v[:, 0])
    o = step.attend(layer, q[:, 0])
    return attn._out_proj(cfg, p, o[:, None], h.shape[0], 1)


def plain_zoned_step(cfg, params, step, tokens):
    """Logits [B, V] of one zoned step through the plain functions alone."""
    x = T._embed_tokens(cfg, params, tokens)
    layer = 0
    for seg, sp in zip(T.decoder_layout(cfg), params["segments"]):
        for layer_p in T._layers(sp, seg.repeats):
            for j, kind in enumerate(seg.kinds):
                p = layer_p[f"k{j}_{kind}"]
                h = apply_norm(cfg, p["ln1"], x)
                a = plain_zoned_attention(cfg, p["attn"], h, step, layer)
                x = T._attn_block_rest(cfg, kind, p, x, h, a)
                layer += 1
    x = apply_norm(cfg, params["final_norm"], x)
    return T._lm_head(cfg, params, x)[:, 0, :]


def randn(*shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def ragged_positions(B, seed, top=4095):
    pos = np.random.default_rng(seed).integers(0, top + 1, B)
    pos[:2] = (0, top)
    return torch.from_numpy(pos).to(torch.int32)


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale_dtype", DTYPES)
@pytest.mark.parametrize("residual", [True, False])
def test_add_rmsnorm_is_the_add_and_apply_norm(dtype, scale_dtype, residual):
    x = randn(8, 1, 96, dtype=dtype, seed=1)
    r = randn(8, 1, 96, dtype=dtype, seed=2, scale=3.0) if residual else None
    scale = randn(96, dtype=scale_dtype, seed=3)
    before = decode_fused.add_rmsnorm.launches
    got_x, got_h = decode_fused.add_rmsnorm(x, r, scale)
    want_x = x + r if residual else x
    assert got_x.dtype == dtype and torch.equal(got_x, want_x)
    if not residual:
        assert got_x is x
    assert torch.equal(got_h, apply_norm(RMS, {"scale": scale}, want_x))
    assert decode_fused.add_rmsnorm.launches == before     # the CPU launched nothing


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [16, 128])
def test_rope_qk_is_rope_of_q_and_of_k(dtype, hd):
    B, H, KV = 6, 4, 2
    q = randn(B, 1, H, hd, dtype=dtype, seed=4)
    k = randn(B, 1, KV, hd, dtype=dtype, seed=5)
    pos = ragged_positions(B, 6)
    got_q, got_k = decode_fused.rope_qk(q[:, 0], k[:, 0],
                                        *decode_fused.rope_table(pos, hd, THETA))
    # the shapes and positions the projections give rope
    assert torch.equal(got_q, rope(q, pos[:, None, None], THETA)[:, 0])
    assert torch.equal(got_k, rope(k, pos[:, None, None], THETA)[:, 0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_is_silu_times_up(dtype):
    gate = randn(4, 1, 300, dtype=dtype, seed=7, scale=4.0)
    up = randn(4, 1, 300, dtype=dtype, seed=8)
    assert torch.equal(decode_fused.swiglu(gate, up), silu(gate) * up)


def test_a_device_without_kernel_or_plain_version_is_refused():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_fused.add_rmsnorm(x, None, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        decode_fused.swiglu(x, x)


def test_vector_width_needs_whole_packs_and_aligned_addresses():
    bf = torch.zeros(64, dtype=torch.bfloat16)
    f32 = torch.zeros(64)
    assert df_kernel._vec(64, bf, f32) == 8           # 16 bytes of bf16; 32 of the f32
    assert df_kernel._vec(60, bf) == 1                # a pack would cross the run
    assert df_kernel._vec(32, bf[1:33]) == 1          # 2 bytes past an aligned address
    assert df_kernel._vec(32, f32[4:36]) == 4         # 16 bytes past one: aligned for 4
    assert df_kernel._vec(32, bf, f32[4:36]) == 1     # the f32 must hold 8 aligned
    assert df_kernel._vec(32, f32, None) == 4


def _zoned_pair(cfg, params):
    """Two zoned caches holding the same three prompts."""
    m = ServeModel(cfg, params, device="cpu")
    rng = np.random.default_rng(9)
    prompts = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
               for k, n in ((0, 13), (1, 5), (2, 9))}
    caches = []
    for _ in range(2):
        c = KVZoneCache(num_layers=cfg.num_layers, num_zones=24, zone_len=4,
                        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        max_zones_per_seq=6, dtype=cdtype(cfg), device="cpu")
        for k, toks in prompts.items():
            m.admit(c, [k], {"tokens": toks})
        caches.append(c)
    return m, caches


# arch -> (calls of add_rmsnorm, rope_qk, swiglu, apply_norm, apply_mlp,
# apply_moe) in one step, per layer L and one final norm
PATHS = {
    # RMS norms, gated SiLU MLPs: every fused call
    "granite-8b": lambda L: (2 * L + 1, L, L, 0, 0, 0),
    # layer norms with bias, a GELU MLP: the plain norm and MLP
    "starcoder2-3b": lambda L: (0, L, 0, 2 * L + 1, L, 0),
    # layer norms and a parallel block: the plain norm and MLP
    "command-r-plus-104b": lambda L: (0, L, 0, L + 1, L, 0),
    # RMS norms fused; the dense first layer's SiLU MLP fused, the MoE plain
    "deepseek-moe-16b": lambda L: (2 * L + 1, L, 1, 0, 0, L - 1),
}


@pytest.mark.parametrize("arch", list(PATHS))
def test_the_zoned_step_fuses_exactly_where_the_config_allows(arch, monkeypatch):
    cfg = get_reduced(arch)
    m, (fused, plain) = _zoned_pair(cfg, init_params(param_specs(cfg), 4, "cpu"))
    calls = dict.fromkeys(("add_rmsnorm", "rope_qk", "swiglu", "apply_norm", "apply_mlp",
                           "apply_moe"), 0)

    def spy(module, name):
        real = getattr(module, name)

        def call(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, call)
    for name in ("add_rmsnorm", "rope_qk", "swiglu"):
        spy(decode_fused, name)
    spy(T, "apply_norm")
    spy(T, "apply_mlp")
    spy(moe_mod, "apply_moe")
    rows = [0, 1, 2]
    tok = torch.tensor([[3], [1], [4]])
    step = fused.reserve(rows)
    got, _ = T.decode_step(cfg, m.tree(), step, tok, step.positions)
    assert tuple(calls.values()) == PATHS[arch](cfg.num_layers)
    step = plain.reserve(rows)
    want = plain_zoned_step(cfg, m.tree(), step, tok)
    assert torch.equal(got, want)
    assert torch.equal(fused.k, plain.k) and torch.equal(fused.v, plain.v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_zoned_steps_follow_the_plain_steps_bit_for_bit(dtype):
    """Five steps of ragged rows through ``decode_sessions`` (the wrappers'
    plain versions on the CPU), against the plain functions' step."""
    cfg = get_reduced("granite-8b").replace(compute_dtype=dtype, param_dtype=dtype)
    m, (fused, plain) = _zoned_pair(cfg, init_params(param_specs(cfg), 5, "cpu"))
    rng = np.random.default_rng(10)
    for _ in range(5):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
        _, got = m.decode_sessions(fused, [2, 0, 1], tok)
        step = plain.reserve([2, 0, 1])
        assert torch.equal(got, plain_zoned_step(cfg, m.tree(), step, tok))
    assert torch.equal(fused.k, plain.k) and torch.equal(fused.v, plain.v)
