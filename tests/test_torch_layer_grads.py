"""Each layer kind's VJP in the port against the JAX package's, on the CPU.

For every layer kind of the 10 architectures (layer 0 of its segment, the
reference's weights in float32), one input, one cotangent of the output and
one of the aux loss go through ``jax.vjp`` of the reference's
``_apply_kind`` and autograd of the port's: the output and each gradient
leaf (the input's and every parameter's) within a relative L2 error of
1e-4 (``grad_share``). One layer, so rounding does not compound. The same
in bfloat16 (weights, input and cotangents) at the port's bf16 tolerance,
2e-2, or twice the reference's own bf16 error where that is larger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_reduced as ref_reduced
from repro.models import transformer as r_transformer
from repro_torch.models import transformer
from repro_torch import _tree
from test_torch_grads import (B, L, bf16_share, grad_share,  # noqa: F401 (fixtures)
                              model_params, models)


def _kinds():
    out = []
    for arch in ARCH_IDS:
        cfg = ref_reduced(arch)
        for seg_key, layout in (("enc_segments", r_transformer.encoder_layout(cfg)),
                                ("segments", r_transformer.decoder_layout(cfg))):
            for s, seg in enumerate(layout):
                for j, kind in enumerate(seg.kinds):
                    if (arch, kind) not in [(a, k) for a, k, *_ in out]:
                        out.append((arch, kind, seg_key, s, f"k{j}_{kind}"))
    return out


KINDS = _kinds()


def _vjps(kind, model, dtype, rounded):
    """The reference's and the port's (output, [input grad, *param grads])
    for one input, one output cotangent and one aux cotangent drawn in
    float32; ``rounded``: the inputs and weights rounded to bf16 first (the
    float32 evaluation of bf16 values). Layer 0 of the kind's segment."""
    rcfg, pcfg, ref, port, seg_key, s, key = model
    rng = np.random.default_rng(21)
    d = rcfg.d_model
    draw = [rng.standard_normal((B, L, d)), rng.standard_normal((B, L, d))]
    daux = np.float32(rng.standard_normal())
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    mem = rng.standard_normal((B, 12, d)) * 0.5
    x, dy, mem = [np.asarray(a, np.float32) for a in (*draw, mem)]
    if rounded:
        x, dy, mem = [np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (x, dy, mem)]
    jx = lambda a: jnp.asarray(a).astype(jnp.dtype(dtype))           # noqa: E731
    tx = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))     # noqa: E731
    rp = jax.tree.map(lambda t: jnp.asarray(t[0]).astype(jnp.dtype(dtype)), ref[seg_key][s][key])
    pp = _tree.tree_map(lambda t: t[0].to(getattr(torch, dtype)), port[seg_key][s][key])
    ctx_r = {"positions": jnp.asarray(pos), "memory": jx(mem)}
    ctx_p = {"positions": torch.from_numpy(pos), "memory": tx(mem)}

    def ref_fn(p, x_):
        y, aux, _ = r_transformer._apply_kind(rcfg, kind, p, x_, ctx_r, False)
        return y, aux
    (y_r, aux_r), vjp = jax.vjp(jax.jit(ref_fn), rp, jx(x))
    dp_r, dx_r = vjp((jx(dy), jnp.asarray(daux, aux_r.dtype)))

    leaves, treedef = _tree.flatten(pp)
    live = [t.detach().requires_grad_(True) for t in leaves]
    xt = tx(x).requires_grad_(True)
    y_p, aux_p, _ = transformer._apply_kind(pcfg, kind, _tree.unflatten(treedef, live), xt,
                                            ctx_p, False)
    outs, cots = [y_p], [tx(dy)]
    if aux_p.requires_grad:           # the MoE kinds' load-balance loss
        outs.append(aux_p)
        cots.append(torch.tensor(daux, dtype=aux_p.dtype))
    grads = torch.autograd.grad(outs, [xt, *live], cots, allow_unused=True,
                                materialize_grads=True)
    paths = ["input"] + [_tree.keystr(p) for p, _ in _tree.flatten_with_path(pp)[0]]
    return (y_r, [dx_r, *jax.tree.leaves(dp_r)]), (y_p, list(grads)), paths


@pytest.mark.parametrize("arch,kind,seg_key,s,key", KINDS, ids=[f"{a}-{k}" for a, k, *_ in KINDS])
def test_layer_kind_vjp_matches_reference(arch, kind, seg_key, s, key, models):
    """The VJP of ``_apply_kind`` (layer 0 of its segment) with respect to
    its input and every parameter, for one input and one cotangent of the
    output and of the aux loss: the output and each gradient leaf within a
    relative L2 error of 1e-4 (``grad_share``)."""
    (y_r, g_r), (y_p, g_p), paths = _vjps(kind, (*models(arch), seg_key, s, key), "float32",
                                          rounded=False)
    share, i = grad_share([y_p], [y_r], 1e-4)
    assert share <= 1.0, f"{arch} {kind}: the output at {share:.3g} of 1e-4"
    share, i = grad_share(g_p, g_r, 1e-4)
    assert share <= 1.0, f"{arch} {kind}: {paths[i]} at {share:.3g} of 1e-4"


@pytest.mark.parametrize("arch,kind,seg_key,s,key", KINDS, ids=[f"{a}-{k}" for a, k, *_ in KINDS])
def test_layer_kind_vjp_matches_reference_bf16(arch, kind, seg_key, s, key, model_params):
    """The same VJP in bfloat16 (the reference's bf16 weights, the input and
    cotangents rounded to bf16): the output and each gradient leaf by
    ``bf16_share``: within BF16_TOL of the reference's, or twice the
    reference's own distance from the float32 VJP of the same bf16 values
    where that is larger; a leaf zero in float32 (the cross-attention key
    bias, zero by symmetry) below NOISE_BF16 of the whole."""
    model = (*model_params(arch, "bfloat16"), seg_key, s, key)
    (y_r, g_r), (y_p, g_p), paths = _vjps(kind, model, "bfloat16", rounded=True)
    rcfg, pcfg, *rest = model
    f32 = (rcfg.replace(compute_dtype="float32", param_dtype="float32"),
           pcfg.replace(compute_dtype="float32", param_dtype="float32"), *rest)
    (y_32, g_32), _, _ = _vjps(kind, f32, "float32", rounded=True)
    share, _, tol = bf16_share([y_p], [y_r], [y_32])
    assert share <= 1.0, f"{arch} {kind}: the output at {share:.3g} of {tol:.3g}"
    share, i, tol = bf16_share(g_p, g_r, g_32)
    assert share <= 1.0, f"{arch} {kind}: {paths[i]} at {share:.3g} of {tol:.3g}"
