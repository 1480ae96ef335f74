"""The reference's per-architecture smoke tests (``tests/test_arch_smoke.py``)
run on the port, on ``device="cpu"``, at the reference's sizes and bounds.

The cases are the reference's: forward shapes and finiteness, one SGD
step on ``loss_fn``'s gradient, two decode steps, token-by-token decode
against the teacher-forced forward (float32, ``rtol = atol = 2e-3``),
prefill then decode against forward (``5e-3``), and the published
parameter counts (the reference's function itself, run against
``repro_torch.configs``). The weights are the port's own ``init_params``.
"""
import ast
import math
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.models import cache_specs, decode_step, forward, init_params, param_specs
from repro_torch.models.api import make_batch
from repro_torch.models.params import ParamSpec
from repro_torch.serve.step import make_prefill_step
from repro_torch import _tree
from repro_torch.train.step import loss_and_grads

BATCH, SEQ = 2, 64
DECODE_CONSISTENCY_ARCHS = [
    "h2o-danube-1.8b", "starcoder2-3b", "granite-8b", "command-r-plus-104b",
    "grok-1-314b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b",
]
PREFILL_ARCHS = ["mamba2-780m", "recurrentgemma-9b", "granite-8b", "h2o-danube-1.8b",
                 "llama-3.2-vision-11b", "seamless-m4t-large-v2"]


def _f32(cfg):
    """A reduced config and its params, all in float32 (as the reference's
    consistency tests make them)."""
    cfg = cfg.replace(compute_dtype="float32", param_dtype="float32")
    specs = _tree.tree_map(lambda s: replace(s, dtype=torch.float32), param_specs(cfg),
                           is_leaf=lambda x: isinstance(x, ParamSpec))
    return cfg, init_params(specs, 0, "cpu")


def _zero_cache(cfg, batch, seq, dtype=None):
    specs = cache_specs(cfg, batch, seq)
    if dtype is not None:
        specs = _tree.tree_map(
            lambda s: replace(s, dtype=dtype if s.dtype == torch.bfloat16 else s.dtype),
            specs, is_leaf=lambda x: isinstance(x, ParamSpec))
    return init_params(specs, 0, "cpu")


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(arch_id):
        if arch_id not in cache:
            cfg = get_reduced(arch_id)
            cache[arch_id] = (cfg, init_params(param_specs(cfg), 0, "cpu"))
        return cache[arch_id]
    return get


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_shapes_and_finite(arch_id, setups):
    cfg, params = setups(arch_id)
    batch = make_batch(cfg, BATCH, SEQ, device="cpu")
    logits, aux, _ = forward(cfg, params, batch, remat=False)
    assert logits.shape == (BATCH, SEQ, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all(), f"{arch_id}: NaN/Inf"
    assert torch.isfinite(aux)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_one_train_step(arch_id, setups):
    cfg, params = setups(arch_id)
    batch = make_batch(cfg, BATCH, SEQ, seed=1, device="cpu")
    loss, _, grads = loss_and_grads(cfg, params, batch)
    leaves, treedef = _tree.flatten(params)
    new_params = _tree.unflatten(treedef, [w - 1e-3 * g.to(w.dtype)
                                           for w, g in zip(leaves, grads)])
    assert torch.isfinite(loss), f"{arch_id}: loss not finite"
    # params actually changed
    changed = [bool((a != b).any()) for a, b in zip(leaves, _tree.leaves(new_params))]
    assert any(changed)
    # loss is in a sane range for random init (~ln V)
    assert 0.1 < float(loss) < 3 * math.log(cfg.vocab_size)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_decode_step_runs(arch_id, setups):
    cfg, params = setups(arch_id)
    cache = _zero_cache(cfg, BATCH, SEQ)
    tokens = torch.zeros((BATCH, 1), dtype=torch.int32)
    logits, cache = decode_step(cfg, params, cache, tokens, 0)
    assert logits.shape == (BATCH, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    logits2, _ = decode_step(cfg, params, cache, tokens + 1, 1)
    assert torch.isfinite(logits2.float()).all()


@pytest.mark.parametrize("arch_id", DECODE_CONSISTENCY_ARCHS)
def test_decode_matches_forward(arch_id):
    """Token-by-token decode reproduces the teacher-forced forward logits.
    Run in f32 so numerical noise can't hide cache-logic bugs."""
    cfg = get_reduced(arch_id)
    if cfg.family == "moe":
        # lift capacity so routing drops no tokens: the teacher-forced pass
        # and the per-token decode otherwise drop *different* tokens
        cfg = cfg.replace(moe_capacity_factor=float(cfg.num_experts / cfg.moe_top_k))
    cfg, params = _f32(cfg)
    T = 12
    batch = make_batch(cfg, 1, T, seed=3, device="cpu")
    ref_logits, _, _ = forward(cfg, params, batch, remat=False)
    cache = _zero_cache(cfg, 1, T, dtype=torch.float32)
    for t in range(T):
        logits, cache = decode_step(cfg, params, cache, batch["tokens"][:, t:t + 1], t)
        torch.testing.assert_close(
            logits.float(), ref_logits[:, t, :].float(), rtol=2e-3, atol=2e-3,
            msg=lambda m: f"{arch_id}: decode diverges from forward at t={t}: {m}")


@pytest.mark.parametrize("arch_id", PREFILL_ARCHS)
def test_prefill_then_decode_matches_forward(arch_id):
    """prefill(0..T-1) -> decode(T-1..) continues exactly like the
    teacher-forced forward pass (cache handoff correctness, f32)."""
    cfg, params = _f32(get_reduced(arch_id))
    T, EXTRA = 8, 4
    full = make_batch(cfg, 1, T + EXTRA, seed=5, device="cpu")
    ref_logits, _, _ = forward(cfg, params, full, remat=False)
    prefix = {k: (v[:, :T] if v.ndim == 2 else v) for k, v in full.items()}
    last_logits, cache = make_prefill_step(cfg)(params, prefix)
    torch.testing.assert_close(last_logits[0], ref_logits[0, T - 1], rtol=2e-3, atol=2e-3)
    cache_full = _zero_cache(cfg, 1, T + EXTRA)

    def fit(pre, z):
        z = z.clone()
        z[tuple(slice(0, s) for s in pre.shape)] = pre.to(z.dtype)
        return z
    cache = _tree.tree_map(fit, cache, cache_full)
    for t in range(T, T + EXTRA):
        logits, cache = decode_step(cfg, params, cache, full["tokens"][:, t:t + 1], t)
        torch.testing.assert_close(
            logits[0], ref_logits[0, t], rtol=5e-3, atol=5e-3,
            msg=lambda m: f"{arch_id}: prefill->decode diverges at t={t}: {m}")


def _reference_case(name):
    """The reference test ``name`` compiled against the port
    (``from repro.`` -> ``from repro_torch.``) at its own lines."""
    path = Path(__file__).with_name("test_arch_smoke.py")
    tree = ast.parse(path.read_text().replace("from repro.", "from repro_torch."))
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
    assert len(body) == 1
    namespace = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), namespace)
    return namespace[name]


test_param_counts_match_published_class = _reference_case(
    "test_param_counts_match_published_class")
