"""The port's gradients against the JAX package's, on the CPU.

The same inputs, drawn from numpy seeds, go through ``repro.models`` and
``repro_torch.models``; the weights are the reference's ``init_params``
output carried across by ``load_reference_params``, in float32, without
x64 (as the reference trains).

* ``loss_fn``'s whole-model gradient per architecture at the reference's
  own float32 bounds, per leaf (``grad_share``); in bfloat16 at one layer,
  at the bf16 module tests' 2e-2 or twice the reference's own bf16 error.
* At depth (h2o-danube-1.8b's reduced widths at 1, 8 and 24 layers), the
  port as close to the reference as the reference is to itself when every
  weight moves by one ulp.
* Remat changes no bit of the gradient, and saves fewer bytes.

``tests/test_torch_layer_grads.py`` holds each layer kind's VJP, and
``tests/test_torch_train.py`` the optimizer and the step; both take their
fixtures and bounds from here.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import loss_fn as r_loss_fn
from repro.models.api import make_batch as r_make_batch
from repro_torch.models import loss_fn
from repro_torch.models.api import make_batch
from repro_torch import _tree
from repro_torch.train.step import loss_and_grads
# E2E_TOL: the reference's own float32 bounds for each architecture (2e-3,
# or 5e-3 for the vision and encoder-decoder models)
from test_torch_models import E2E_TOL, model_params  # noqa: F401 (fixture)

B, L = 2, 16


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jax.device_get(x), np.float64)


@pytest.fixture(scope="module")
def models(model_params):
    """(reference config, port config, reference params, port params) of an
    arch's reduced size in float32, made once."""
    return lambda arch: model_params(arch, "float32")


NOISE = 1e-6      # of the whole gradient's norm: a leaf below it is rounding noise
# a leaf that is zero in float32 (below NOISE) is bf16 rounding noise in
# bfloat16: 5e-6 to 8e-5 of the whole (the cross-attention key biases)
NOISE_BF16 = 1e-3
BF16_TOL = 2e-2   # the port's bf16 tolerance (tests/test_torch_models.py::TOL)


def _norm_of(leaves) -> float:
    return math.sqrt(sum(float(np.sum(host(w) ** 2)) for w in leaves))


def grad_share(got: list, want: list, tol, noise: float = NOISE,
               zero=None) -> tuple[float, int]:
    """The largest per-leaf share of its bound and that leaf's index. A
    leaf's bound is ``||got - want|| <= tol ||want||`` (``tol`` a number or
    one per leaf), unless the leaf is zero: softmax ignores a shift shared
    by every key, so a key bias's true gradient is zero and both packages
    compute rounding noise (about 1e-10 of the whole in float32), where a
    relative error says nothing. Such a leaf must be noise in the port too:
    ``||got|| <= noise * whole``. The zero leaves are ``zero`` (one flag per
    leaf), or by default those of ``want`` below ``noise`` of the whole."""
    tols = list(tol) if np.ndim(tol) else [tol] * len(want)
    whole = _norm_of(want)
    if zero is None:
        zero = [np.linalg.norm(host(w)) < noise * whole for w in want]
    shares = []
    for g, w, t, z in zip(got, want, tols, zero, strict=True):
        g, w = host(g), host(w)
        if z:
            shares.append(float(np.linalg.norm(g) / max(noise * whole, 1e-30)))
        else:
            shares.append(float(np.linalg.norm(g - w) / (t * np.linalg.norm(w))))
    i = int(np.argmax(shares))
    return shares[i], i


def bf16_share(got: list, want: list, want_f32: list) -> tuple[float, int]:
    """``grad_share`` of a bf16 result: each leaf within BF16_TOL of the
    reference's, or twice the reference's own distance from the float32
    evaluation of the same bf16 values where that is larger (a port no
    less accurate than the reference lies within that distance of the
    float32 result too, so the two lie within twice it of each other). A
    leaf zero in float32 (below NOISE of the whole) must stay below
    NOISE_BF16 of the whole."""
    whole = _norm_of(want_f32)
    zero = [np.linalg.norm(host(t)) < NOISE * whole for t in want_f32]
    tols = [max(BF16_TOL, 2 * float(np.linalg.norm(host(a) - host(b))
                                    / max(np.linalg.norm(host(b)), 1e-30)))
            for a, b in zip(want, want_f32, strict=True)]
    share, i = grad_share(got, want, tols, NOISE_BF16, zero)
    return share, i, tols[i]


@pytest.fixture(scope="module")
def ref_grads(models):
    """The reference's ``jax.value_and_grad`` of ``loss_fn`` per arch (one
    jit each) on ``make_batch(seed 11)``."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, _, ref, _ = models(arch)
            batch = r_make_batch(rcfg, B, L, seed=11)
            (loss, parts), grads = jax.jit(jax.value_and_grad(
                lambda p, b: r_loss_fn(rcfg, p, b), has_aux=True))(ref, batch)
            cache[arch] = (loss, parts, jax.tree.leaves(jax.device_get(grads)))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_grads_match_reference(arch, models, ref_grads):
    """Every leaf of ``loss_fn``'s gradient within E2E_TOL[arch] of the
    reference's, as a per-leaf relative L2 error (``grad_share``). The
    reference's own float32 tests hold two evaluation orders of one of
    these models to 2e-3 (5e-3 for vision and encoder-decoder), and the
    reduced models are ill-conditioned (the comment above
    ``tests/test_torch_models.py::E2E_TOL``), so the gradient, a chain of
    the same operations run backwards, is held to the same bounds."""
    _, pcfg, _, port = models(arch)
    loss_r, parts_r, grads_r = ref_grads(arch)
    loss, parts, grads = loss_and_grads(pcfg, port, make_batch(pcfg, B, L, seed=11, device="cpu"))
    np.testing.assert_allclose(host(loss), host(loss_r), rtol=E2E_TOL[arch])
    np.testing.assert_allclose(host(parts["aux"]), host(parts_r["aux"]), rtol=E2E_TOL[arch],
                               atol=1e-6)
    assert len(grads) == len(grads_r)
    for g, w in zip(grads, grads_r):
        assert tuple(g.shape) == np.shape(w) and g.dtype == torch.float32
    share, i = grad_share(grads, grads_r, E2E_TOL[arch])
    path = _tree.keystr(_tree.flatten_with_path(port)[0][i][0])
    assert share <= 1.0, f"{arch}: {path} at {share:.3g} of {E2E_TOL[arch]}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_changes_no_bit_of_the_gradient(arch, models):
    """``remat=True`` recomputes each layer in the backward pass (it saves
    fewer bytes for backward) and gives the same gradient bit for bit."""
    _, pcfg, _, port = models(arch)
    batch = make_batch(pcfg, B, L, seed=11, device="cpu")
    leaves, treedef = _tree.flatten(port)
    out = {}
    for remat in (False, True):
        live = [t.detach().requires_grad_(True) for t in leaves]
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(pcfg, _tree.unflatten(treedef, live), batch, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        out[remat] = (loss.detach(), grads, saved[0])
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    assert out[True][2] < out[False][2]


def one_layer(arch) -> dict:
    """An arch's reduced widths cut to one layer (and one encoder layer)."""
    return {"num_layers": 1, **({"encoder_layers": 1} if arch.startswith("seamless") else {})}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_grads_match_reference_bf16(arch, model_params):
    """In bfloat16 at one layer (two deep for seamless-m4t: an encoder layer
    feeds the decoder's cross-attention), the loss and every leaf of
    ``loss_fn``'s gradient against the reference's, per-leaf relative L2,
    by ``bf16_share``: within BF16_TOL, the bound the bf16 module tests hold
    one layer's pieces to, or twice the reference's own bf16 distance from
    its float32 evaluation of the same bf16 weights where that is larger.
    Deeper, bf16 rounding decides the gradient of these randomly
    initialised models: their attention logits are of order 1,000 (the
    comment above ``test_torch_models.E2E_TOL``), where one bf16 step is
    about 4."""
    rcfg, pcfg, ref, port = model_params(arch, "bfloat16", **one_layer(arch))
    batch = r_make_batch(rcfg, B, L, seed=11)

    def ref_grads_of(cfg, params):
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: r_loss_fn(cfg, p, b), has_aux=True))(params, batch)
        return loss, jax.tree.leaves(jax.device_get(g))
    loss_r, grads_r = ref_grads_of(rcfg, ref)
    _, grads_32 = ref_grads_of(rcfg.replace(compute_dtype="float32", param_dtype="float32"),
                               jax.tree.map(lambda x: np.asarray(x, np.float32), ref))
    loss, _, grads = loss_and_grads(pcfg, port, make_batch(pcfg, B, L, seed=11, device="cpu"))
    np.testing.assert_allclose(host(loss), host(loss_r), rtol=BF16_TOL)
    for g, w in zip(grads, grads_r, strict=True):
        assert tuple(g.shape) == np.shape(w) and str(g.dtype) == f"torch.{w.dtype}"
    share, i, tol = bf16_share(grads, grads_r, grads_32)
    path = _tree.keystr(_tree.flatten_with_path(port)[0][i][0])
    assert share <= 1.0, f"{arch}: {path} at {share:.3g} of {tol:.3g}"


DEEP_ARCH = "h2o-danube-1.8b"     # the train phase's architecture
ULP_DRAWS = 4
DEEP_SLACK = 2


def _one_ulp(tree, seed):
    """Every float32 weight moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.nextafter(
        x, np.where(rng.random(x.shape) < 0.5, -np.inf, np.inf).astype(x.dtype)), tree)


@pytest.mark.parametrize("layers", [1, 8, 24])
def test_deep_grads_match_reference(layers, model_params):
    """The gradient at depth, float32: h2o-danube-1.8b's reduced widths at
    1, 8 and 24 layers. The reference's initialisation (``fan_in`` of a
    ``[d, H, hd]`` weight is H) makes the gradient grow with depth (its
    norm about 41 at one layer, 1.8e3 at 8, 3.6e4 at 24) and its direction
    sensitive to rounding: moving every weight by one ulp moves the
    reference's own gradient by up to about 1e-5 at one layer and 1-4 % at
    24. The port rounds differently in every operation, which is no larger
    a change, so each leaf is held within DEEP_SLACK times the largest
    per-leaf relative distance that ULP_DRAWS such moves give the
    reference (the port has read 0.34-0.58 of it at 1 to 24 layers). A
    fault of the backward pass at depth (a layer's gradient dropped or
    recomputed from the wrong input) moves leaves by order one."""
    rcfg, pcfg, ref, port = model_params(DEEP_ARCH, "float32", num_layers=layers)
    grad = jax.jit(jax.grad(lambda p, b: r_loss_fn(rcfg, p, b)[0]))
    batch = r_make_batch(rcfg, B, L, seed=11)
    want = jax.tree.leaves(jax.device_get(grad(ref, batch)))
    spread = max(grad_share(jax.tree.leaves(jax.device_get(grad(_one_ulp(ref, 100 + s), batch))),
                            want, 1.0)[0] for s in range(ULP_DRAWS))
    _, _, got = loss_and_grads(pcfg, port, make_batch(pcfg, B, L, seed=11, device="cpu"))
    share, i = grad_share(got, want, DEEP_SLACK * spread)
    norms = [math.sqrt(sum(float(np.sum(host(g) ** 2)) for g in x)) for x in (want, got)]
    print(f"{DEEP_ARCH} reduced x {layers} layers: grad norm reference {norms[0]:.6g} "
          f"port {norms[1]:.6g}; one-ulp spread {spread:.3g}; share {share:.3g}")
    path = _tree.keystr(_tree.flatten_with_path(port)[0][i][0])
    assert share <= 1.0, f"{layers} layers: {path} at {share:.3g} of {DEEP_SLACK} x {spread:.3g}"
