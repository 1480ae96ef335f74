"""The port's serve entry point and parameter machinery against the JAX
package, on the CPU.

``ServeModel.generate`` (prefill, the cache handoff, greedy decode) must
produce the reference's tokens: a greedy loop over ``make_prefill_step``
and ``make_serve_step`` of ``repro.serve.step``, with the cache grown as
``tests/test_arch_smoke.py::test_prefill_then_decode_matches_forward`` grows
it, for every architecture at its ``reduced()`` size in float32, weights
carried by ``load_reference_params``. Its logits are held at the bound the
reference's own tests hold that architecture to end to end
(``test_torch_models.py`` says why). Then: the port's ``init_params``,
``load_reference_params``' refusals, the inputs and abstract specs of
``models/api.py``, and the default device.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_reduced as ref_reduced
from repro.models import abstract_params as r_abstract_params
from repro.models import cache_specs as r_cache_specs
from repro.models import init_params as r_init_params
from repro.models import param_specs as r_param_specs
from repro.models.api import decode_input_specs as r_decode_input_specs
from repro.models.api import make_batch as r_make_batch
from repro.models.api import make_decode_inputs as r_make_decode_inputs
from repro.models.api import train_input_specs as r_train_input_specs
from repro.models.config import SHAPES
from repro.models.params import ParamSpec as RefSpec
from repro.serve.step import make_prefill_step as r_make_prefill_step
from repro.serve.step import make_serve_step as r_make_serve_step
from repro_torch.configs import get_reduced
from repro_torch.models import abstract_params, init_params, param_specs
from repro_torch.models.api import (decode_input_specs, make_batch, make_decode_inputs,
                                    train_input_specs)
from repro_torch.models.params import ParamSpec, load_reference_params, spec_tree_paths
from repro_torch.serve import ServeModel, make_prefill_step, make_serve_step
from repro_torch import _tree

B, L, NEW = 2, 16, 5
DECODE_CONSISTENCY_ARCHS = [          # tests/test_arch_smoke.py
    "h2o-danube-1.8b", "starcoder2-3b", "granite-8b", "command-r-plus-104b",
    "grok-1-314b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b",
]
TOL = {a: 2e-3 if a in DECODE_CONSISTENCY_ARCHS else 5e-3 for a in ARCH_IDS}


def f32_configs(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    return ref_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)


def f32_reference_params(rcfg):
    specs = jax.tree.map(lambda s: RefSpec(s.shape, s.axes, s.init, jnp.float32, s.init_scale),
                         r_param_specs(rcfg), is_leaf=lambda x: isinstance(x, RefSpec))
    return jax.device_get(r_init_params(specs, jax.random.PRNGKey(0)))


def f32_specs(pcfg):
    return _tree.tree_map(lambda s: replace(s, dtype=torch.float32), param_specs(pcfg),
                          is_leaf=lambda x: isinstance(x, ParamSpec))


def reference_greedy(rcfg, params, batch, new):
    """The reference's serving steps in a greedy loop: prefill, grow the
    cache to L + new positions, decode."""
    prefill = jax.jit(r_make_prefill_step(rcfg))
    step = jax.jit(r_make_serve_step(rcfg))
    last, cache = prefill(params, batch)
    n = batch["tokens"].shape[1]
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), r_cache_specs(rcfg, B, n + new),
                         is_leaf=lambda x: isinstance(x, RefSpec))

    def fit(pre, z):
        if pre.shape == z.shape:
            return pre.astype(z.dtype)
        return z.at[tuple(slice(0, s) for s in pre.shape)].set(pre.astype(z.dtype))
    cache = jax.tree.map(fit, cache, zeros)
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    tokens, logits = [tok], [last]
    for t in range(new - 1):
        tok, lg, cache = step(params, cache, tok, jnp.asarray(n + t, jnp.int32))
        tokens.append(tok)
        logits.append(lg)
    return np.asarray(jnp.concatenate(tokens, 1)), np.asarray(jnp.stack(logits, 1))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_generate_matches_reference_greedy_loop(arch):
    rcfg, pcfg = f32_configs(arch)
    ref = f32_reference_params(rcfg)
    batch = r_make_batch(rcfg, B, L, seed=21)
    want_tokens, want_logits = reference_greedy(rcfg, ref, batch, NEW)
    model = ServeModel(pcfg, load_reference_params(pcfg, ref, "cpu", specs=f32_specs(pcfg)),
                       device="cpu")
    tokens, logits = model.generate(make_batch(pcfg, B, L, seed=21, device="cpu"), NEW)
    assert tokens.dtype == torch.int32 and tokens.shape == (B, NEW)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL[arch], atol=TOL[arch])


def test_serve_and_prefill_steps_follow_the_reference_contract():
    rcfg, pcfg = f32_configs("granite-8b")
    params = init_params(f32_specs(pcfg), 0, "cpu")
    batch = make_batch(pcfg, B, L, seed=1, device="cpu")
    last, cache = make_prefill_step(pcfg)(params, batch)
    assert last.shape == (B, pcfg.vocab_size)
    assert [tuple(c["k0_attn_mlp"]["k"].shape) for c in cache] == [
        (pcfg.num_layers, B, L, pcfg.num_kv_heads, pcfg.head_dim)]
    tokens, pos, zero_cache = make_decode_inputs(pcfg, B, L, device="cpu")
    nxt, logits, out = make_serve_step(pcfg)(params, zero_cache, tokens, pos)
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
    assert torch.equal(nxt[:, 0], logits.argmax(-1).int())
    assert out is zero_cache and bool(zero_cache[0]["k0_attn_mlp"]["k"][:, :, 0].abs().sum() > 0)
    with pytest.raises(ValueError, match="greedy"):
        make_serve_step(pcfg, sample="top_p")


def test_serve_model_registers_the_reference_paths():
    rcfg, pcfg = f32_configs("deepseek-moe-16b")
    ref = f32_reference_params(rcfg)
    params = load_reference_params(pcfg, ref, "cpu", specs=f32_specs(pcfg))
    model = ServeModel(pcfg, params, device="cpu")
    assert list(model.parameters()) == []
    flat, _ = _tree.flatten_with_path(params)
    keys = {"params." + ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
            for path, _ in flat}
    assert set(model.state_dict()) == keys
    got, _ = _tree.flatten_with_path(model.tree())
    assert [_tree.keystr(p) for p, _ in got] == [_tree.keystr(p) for p, _ in flat]
    assert all(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in zip(got, flat))
    with pytest.raises(ValueError, match="max_new_tokens"):
        model.generate(make_batch(pcfg, 1, 4, device="cpu"), 0)


# ------------------------------------------------------------- parameters

def test_init_params_is_independent_of_insertion_order():
    pcfg = get_reduced("recurrentgemma-9b")
    specs = param_specs(pcfg)

    def reverse(tree):
        if isinstance(tree, dict):
            return {k: reverse(tree[k]) for k in reversed(list(tree))}
        if isinstance(tree, list):
            return [reverse(x) for x in tree]
        return tree
    a = init_params(specs, 3, "cpu")
    b = init_params(reverse(specs), 3, "cpu")
    la, lb = _tree.leaves(a), _tree.leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    c = init_params(specs, 4, "cpu")
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    # a leaf added to the tree leaves every other leaf's values as they were
    grown = init_params(dict(specs, aa_extra=ParamSpec((8,), ("embed",))), 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        la, _tree.leaves({k: v for k, v in grown.items() if k != "aa_extra"})))


def test_init_params_dtypes_and_moments():
    pcfg = get_reduced("recurrentgemma-9b")
    specs = param_specs(pcfg)
    params = init_params(specs, 0, "cpu")
    got = dict(zip([p for p, _ in spec_tree_paths(specs)], _tree.leaves(params)))
    for path, spec in spec_tree_paths(specs):
        x = got[path]
        assert x.dtype == spec.dtype and tuple(x.shape) == spec.shape, path
        xf = x.double()
        if spec.init == "zeros":
            assert torch.all(xf == 0), path
        elif spec.init == "ones":
            assert torch.all(xf == 1), path
        elif spec.init == "rglru_a":
            lo, hi = np.log(0.9 ** 2 / (1 - 0.9 ** 2)), np.log(0.999 ** 2 / (1 - 0.999 ** 2))
            assert lo - 1e-3 <= float(xf.min()) and float(xf.max()) <= hi + 1e-3, path
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = 1 / np.sqrt(fan_in) if spec.init == "fan_in" else spec.init_scale
            n = xf.numel()
            assert abs(float(xf.mean())) < 5 * std / np.sqrt(n), path
            assert abs(float(xf.std()) / std - 1) < 5 / np.sqrt(n) + 0.01, path
    assert params["segments"][0]["k0_rglru"]["rec"]["lam"].dtype == torch.float32


def test_param_paths_equal_the_reference():
    """Leaves are named, ordered and seeded by the same path strings as the
    reference's ``init_params`` (``jax.tree_util.keystr``)."""
    rcfg, pcfg = ref_reduced("llama-3.2-vision-11b"), get_reduced("llama-3.2-vision-11b")
    ref_paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        r_param_specs(rcfg), is_leaf=lambda x: isinstance(x, RefSpec))[0]]
    assert [p for p, _ in spec_tree_paths(param_specs(pcfg))] == ref_paths


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch):
    rcfg, pcfg = ref_reduced(arch), get_reduced(arch)
    want = jax.tree_util.tree_flatten_with_path(r_abstract_params(r_param_specs(rcfg)))[0]
    got = _tree.flatten_with_path(abstract_params(param_specs(pcfg)))[0]
    assert [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype)) for p, s in want] == [
        (_tree.keystr(p), tuple(t.shape), str(t.dtype).removeprefix("torch."))
        for p, t in got]
    assert all(t.device.type == "meta" for _, t in got)
    shape = SHAPES["decode_32k"]
    for rspec, pspec in ((r_train_input_specs(rcfg, shape), train_input_specs(pcfg, shape)),
                         (r_decode_input_specs(rcfg, shape), decode_input_specs(pcfg, shape))):
        w = jax.tree_util.tree_flatten_with_path(rspec)[0]
        g = _tree.flatten_with_path(pspec)[0]
        assert [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype)) for p, s in w] == [
            (_tree.keystr(p), tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in g]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_equal_the_reference(arch):
    rcfg, pcfg = ref_reduced(arch), get_reduced(arch)
    want = jax.device_get(r_make_batch(rcfg, 2, 8, seed=5))
    got = make_batch(pcfg, 2, 8, seed=5, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        a, name = _tree.leaf_to_host(got[k])
        b, ref_name = _tree.leaf_to_host(want[k])
        assert name == ref_name and np.array_equal(a, b), k
    tokens, pos, cache = make_decode_inputs(pcfg, 2, 8, seed=5, device="cpu")
    r_tokens, r_pos, r_cache = r_make_decode_inputs(rcfg, 2, 8, seed=5)
    assert np.array_equal(tokens.numpy(), np.asarray(r_tokens)) and pos == int(r_pos)
    assert all(float(t.abs().sum()) == 0 for t in _tree.leaves(cache))
    assert [tuple(t.shape) for t in _tree.leaves(cache)] == [
        tuple(x.shape) for x in jax.tree.leaves(r_cache)]


def test_load_reference_params_refuses_a_wrong_tree():
    rcfg, pcfg = ref_reduced("granite-8b"), get_reduced("granite-8b")
    tree = jax.device_get(r_init_params(r_param_specs(rcfg), jax.random.PRNGKey(0)))
    params = load_reference_params(pcfg, tree, "cpu")
    assert params["embed"]["tok"].dtype == torch.bfloat16
    a, _ = _tree.leaf_to_host(params["embed"]["tok"])
    b, _ = _tree.leaf_to_host(tree["embed"]["tok"])
    assert np.array_equal(a, b)

    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match=r"missing leaves \[\"\['final_norm'\]\['scale'\]\"\]"):
        load_reference_params(pcfg, missing, "cpu")
    extra = dict(tree, final_norm=dict(tree["final_norm"], bias=np.zeros(64, np.float32)))
    with pytest.raises(ValueError, match="extra leaves"):
        load_reference_params(pcfg, extra, "cpu")
    seg = dict(tree["segments"][0])
    seg["k0_attn_mlp"] = dict(seg["k0_attn_mlp"], attn=dict(
        seg["k0_attn_mlp"]["attn"], wq=np.asarray(seg["k0_attn_mlp"]["attn"]["wq"])[:, :, :, :8]))
    with pytest.raises(ValueError, match=r"\['wq'\] is bfloat16\[3, 64, 4, 8\]"):
        load_reference_params(pcfg, dict(tree, segments=[seg]), "cpu")
    f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    with pytest.raises(ValueError, match="float32.*spec is bfloat16"):
        load_reference_params(pcfg, f32, "cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = get_reduced("granite-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(param_specs(pcfg), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(pcfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_decode_inputs(pcfg, 1, 4)
    params = init_params(param_specs(pcfg), 0, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeModel(pcfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_reference_params(pcfg, _tree.tree_map(lambda t: t, params))
    assert ServeModel(pcfg, params, device="cpu").device == torch.device("cpu")
