"""The port's paged decode attention against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch version
(``repro_torch/kernels/paged_attn/ref.py``); the reference's Pallas kernel
runs in interpret mode, as its own tests run it, and its jnp oracle beside
it. The same numpy inputs go to both packages: float32 directly, bfloat16
as the bits of the jnp array (viewed as uint16, then as torch.bfloat16).
Tolerances are the reference tests': 2e-5 in float32, 2e-2 in bfloat16,
where the two round at other places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ops import paged_attention as jax_paged_attention
from repro.kernels.paged_attn.ref import paged_attention_ref as jax_paged_attention_ref
from repro_torch.kernels.paged_attn import kernel as pa_kernel
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.serve import KVZonePool

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _tables(rng, B, NZ, ZL, MZ):
    """Random distinct zones per sequence with a -1 tail and a length inside
    them (tests/test_kernels.py::_paged_case)."""
    ztab = np.full((B, MZ), -1, np.int32)
    lengths = np.zeros((B,), np.int32)
    for b in range(B):
        nz = rng.integers(1, MZ + 1)
        ztab[b, :nz] = rng.choice(NZ, size=nz, replace=False)
        lengths[b] = rng.integers(1, nz * ZL + 1)
    return ztab, lengths


def _to_torch(x):
    """A jnp array as a torch tensor with the same bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(B, H, KV, hd, NZ, ZL, MZ, seed, dtype="float32", edit=None):
    """(jnp inputs, torch inputs) from one numpy draw; ``edit(ztab,
    lengths)`` changes the tables in place before both sides see them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((NZ, ZL, KV, hd)).astype(np.float32)
    v = rng.standard_normal((NZ, ZL, KV, hd)).astype(np.float32)
    ztab, lengths = _tables(rng, B, NZ, ZL, MZ)
    if edit is not None:
        edit(ztab, lengths)
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)) + (
        jnp.asarray(ztab), jnp.asarray(lengths))
    tx = tuple(_to_torch(a) for a in jx)
    return jx, tx


def _assert_close(got: torch.Tensor, want, tol: float):
    assert got.dtype == _to_torch(want).dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_both(jx, tx, dtype):
    got = paged_attention(*tx)
    _assert_close(got, jax_paged_attention(*jx, interpret=True), TOL[dtype])
    _assert_close(got, jax_paged_attention_ref(*jx), TOL[dtype])
    return got


# tests/test_kernels.py:145-149
GEOMETRIES = [
    (1, 4, 4, 32, 4, 16, 2),     # MHA
    (2, 8, 2, 64, 8, 32, 3),     # GQA
    (4, 8, 1, 128, 16, 128, 4),  # MQA, bigger zones
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,NZ,ZL,MZ", GEOMETRIES)
def test_paged_attention_matches_reference(B, H, KV, hd, NZ, ZL, MZ, dtype):
    jx, tx = _inputs(B, H, KV, hd, NZ, ZL, MZ, seed=B, dtype=dtype)
    _check_both(jx, tx, dtype)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_paged_attention_random_tables(seed):
    jx, tx = _inputs(3, 6, 2, 32, 8, 16, 4, seed=1000 + seed)
    _check_both(jx, tx, "float32")


def test_paged_attention_bf16():
    jx, tx = _inputs(2, 8, 4, 64, 6, 32, 3, seed=9, dtype="bfloat16")
    _check_both(jx, tx, "bfloat16")


def _length_zero(ztab, lengths):
    lengths[0] = 0


def _all_minus_one(ztab, lengths):
    ztab[1] = -1
    lengths[1] = 2 * 16


def _hole_in_the_middle(ztab, lengths):
    ztab[2] = [5, -1, 6, 7]
    lengths[2] = 4 * 16


def _full_length(ztab, lengths):
    ztab[0] = [3, 1, 4, 0]
    lengths[0] = 4 * 16


def _first_zone_unused(ztab, lengths):
    ztab[1] = [-1, 2, -1, -1]
    lengths[1] = 16 + 5


EDGES = {"length_zero": _length_zero, "all_minus_one": _all_minus_one,
         "hole_in_the_middle": _hole_in_the_middle, "full_length": _full_length,
         "first_zone_unused": _first_zone_unused}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_paged_attention_edge_rows(edge, dtype):
    jx, tx = _inputs(3, 8, 2, 32, 8, 16, 4, seed=21, dtype=dtype, edit=EDGES[edge])
    _check_both(jx, tx, dtype)


def test_no_valid_position_is_the_uniform_mean_of_v():
    """A row with no valid position reads every clamped position with the same
    weight: zone 0 once for each -1 entry."""
    _, (q, k, v, tab, lengths) = _inputs(3, 8, 2, 32, 8, 16, 4, seed=5,
                                         edit=_length_zero)
    got = paged_attention(q, k, v, tab, lengths)
    safe = tab[0].long().clamp(min=0)
    want = v[safe].reshape(-1, 2, 32).mean(0)              # [KV, hd]
    torch.testing.assert_close(got[0].reshape(2, 4, 32),
                               want[:, None, :].expand(2, 4, 32),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_80(dtype):
    jx, tx = _inputs(2, 32, 8, 80, 6, 16, 3, seed=80, dtype=dtype)
    _check_both(jx, tx, dtype)


def test_cpu_call_launches_nothing():
    before = pa_kernel.paged_attention_kernel.launches
    _, tx = _inputs(2, 8, 2, 64, 8, 32, 3, seed=3)
    out = pa_kernel.paged_attention_kernel(*tx)
    assert torch.equal(out, paged_attention_ref(*tx))
    assert pa_kernel.paged_attention_kernel.launches == before == 0


def test_kernel_wrapper_and_pool_refuse_a_missing_card(monkeypatch):
    """Tensors that are neither on the CPU nor on a card are refused, not
    sent to the plain version; the pool asked for the card without one
    raises."""
    _, tx = _inputs(2, 8, 2, 64, 8, 32, 3, seed=3)
    with pytest.raises(ValueError, match="unsupported device"):
        pa_kernel.paged_attention_kernel(*(t.to("meta") for t in tx))
    assert pa_kernel.paged_attention_kernel.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVZonePool(num_zones=2, zone_len=4, kv_heads=1, head_dim=8,
                   max_zones_per_seq=1)


def _bad(change):
    def make():
        _, (q, k, v, tab, lengths) = _inputs(2, 8, 2, 64, 8, 32, 3, seed=3)
        return change(q, k, v, tab, lengths)
    return make


BAD_INPUTS = {
    "head_dim_not_multiple_of_8": (_bad(lambda q, k, v, t, n: (
        q[..., :60].contiguous(), k[..., :60].contiguous(), v[..., :60].contiguous(),
        t, n)), ValueError),
    "head_dim_above_256": (_bad(lambda q, k, v, t, n: (
        q.repeat(1, 1, 5), k.repeat(1, 1, 1, 5), v.repeat(1, 1, 1, 5), t, n)), ValueError),
    "heads_not_multiple_of_kv": (_bad(lambda q, k, v, t, n: (
        q[:, :7].contiguous(), k, v, t, n)), ValueError),
    "float16": (_bad(lambda q, k, v, t, n: (q.half(), k.half(), v.half(), t, n)), TypeError),
    "mixed_dtypes": (_bad(lambda q, k, v, t, n: (q.bfloat16(), k, v, t, n)), TypeError),
    "int64_table": (_bad(lambda q, k, v, t, n: (q, k, v, t.long(), n)), ValueError),
    "short_lengths": (_bad(lambda q, k, v, t, n: (q, k, v, t, n[:1])), ValueError),
    "strided_pool": (_bad(lambda q, k, v, t, n: (
        q, k.transpose(0, 1), v.transpose(0, 1), t, n)), ValueError),
    "v_shape": (_bad(lambda q, k, v, t, n: (q, k, v[:4], t, n)), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_kernel_checks_refuse_what_it_does_not_take(case):
    make, error = BAD_INPUTS[case]
    with pytest.raises(error):
        pa_kernel._check(*make())


def test_kernel_checks_accept_the_main_path_shapes():
    for dtype in ("float32", "bfloat16"):
        _, tx = _inputs(2, 32, 8, 80, 6, 16, 3, seed=1, dtype=dtype)
        pa_kernel._check(*tx)
