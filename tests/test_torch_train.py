"""The port's training path against the JAX package's, on the CPU.

The same inputs, drawn from numpy seeds, go through ``repro.train`` and its
port; the weights are the reference's ``init_params`` output carried across
by ``load_reference_params``, in float32 (fixtures and bounds shared with
``tests/test_torch_grads.py``, which holds the gradients). JAX runs without
x64, as the reference's training does (``cosine_lr``'s ``step / warmup``
would widen to float64 under x64).

* The optimizer: ``adamw_update``, ``cosine_lr`` and the int8 compression
  on random trees at ``rtol = 1e-6``.
* The train step over 3 steps from one carried state against the
  reference's jitted step, with ``grad_accum`` 1 and 2 and compression off
  (the model's gradients) and on (a linear loss whose gradients both
  packages compute bit for bit; see the compressed case's docstring).
* The reference's optimizer tests (``tests/test_train_extras.py``, less its
  sharding cases) and ``tests/test_checkpoint.py::test_preemption_exact_resume``
  on the port; the CLI, with a resume; the card default.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.models.api import make_batch as r_make_batch
from repro.train import optimizer as r_opt
from repro.train.step import TrainHyper as RefTrainHyper
from repro.train.step import make_train_step as r_make_train_step
from repro.configs import ARCH_IDS
from repro_torch.configs import get_config, get_reduced
from repro_torch.models.api import make_batch
from repro_torch.models.params import ParamSpec, abstract_params, init_params
from repro_torch import _tree
from repro_torch.train.checkpoint import ZonedCheckpointStore
from repro_torch.train.optimizer import (AdamWHyper, adamw_update, compress_int8,
                                         cosine_lr, decompress_int8)
from repro_torch.train.step import (TrainHyper, init_state, loss_and_grads, make_train_step,
                                    train_state_specs)
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_grads import E2E_TOL, L, grad_share, host, model_params, models  # noqa: F401 (fixtures)

# --------------------------------------------------------------- optimizer

def _random_tree(rng, scale=1.0):
    return {"w": rng.standard_normal((8, 16)) * scale, "b": rng.standard_normal(16) * scale,
            "layers": [rng.standard_normal((3, 4, 5)) * scale]}


def _both(tree):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return (jax.tree.map(jnp.asarray, tree),
            _tree.tree_map(lambda a: torch.from_numpy(a.copy()), tree))


def close_tree(got, want, rtol):
    """Each leaf within ``rtol`` of the reference, relative to its values
    and, for values near zero, to the leaf's largest."""
    g, w = _tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(host(a), host(b), rtol=rtol,
                                   atol=rtol * float(np.abs(host(b)).max()))


@pytest.mark.parametrize("step", [0, 1, 7, 99, 100, 101, 5_000, 9_999, 10_000, 12_000])
def test_cosine_lr_matches_reference(step):
    h = AdamWHyper(lr=3e-4, warmup_steps=100, total_steps=10_000)
    for dtype in ("int32", "float32"):
        want = r_opt.cosine_lr(r_opt.AdamWHyper(lr=3e-4, warmup_steps=100, total_steps=10_000),
                               jnp.asarray(step, dtype))
        got = cosine_lr(h, torch.tensor(step, dtype=getattr(torch, dtype)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(host(got), host(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("step,clip", [(0, 1.0), (3, 1.0), (150, 1e3)])
def test_adamw_update_matches_reference(step, clip):
    """Three updates from zero moments on a random tree of mixed ranks
    (decay on matrices only), clipped (clip 1) and not (clip 1e3)."""
    rng = np.random.default_rng(step)
    hj = r_opt.AdamWHyper(lr=1e-2, warmup_steps=10, total_steps=200, grad_clip=clip)
    ht = AdamWHyper(lr=1e-2, warmup_steps=10, total_steps=200, grad_clip=clip)
    pj, pt = _both(_random_tree(rng))
    mj, mt = _both(jax.tree.map(np.zeros_like, _random_tree(rng)))
    vj, vt = _both(jax.tree.map(np.zeros_like, _random_tree(rng)))
    for i in range(3):
        gj, gt = _both(_random_tree(rng, scale=0.3))
        pj, mj, vj, mets_j = r_opt.adamw_update(pj, gj, mj, vj, jnp.asarray(step + i), hj)
        out = adamw_update(pt, gt, mt, vt, torch.tensor(step + i, dtype=torch.int32), ht)
        assert out[0] is pt and out[1] is mt and out[2] is vt      # in place
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(host(out[3][name]), host(mets_j[name]), rtol=1e-6)
        close_tree(pt, pj, 1e-6)
        close_tree(mt, mj, 1e-6)
        close_tree(vt, vj, 1e-6)


def test_adamw_update_bf16_params_round_back():
    """bf16 params are updated in float32 and rounded back to bf16."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((16, 32)).astype(np.float32)
    g = rng.standard_normal((16, 32)).astype(np.float32)
    pj = {"w": jnp.asarray(p).astype(jnp.bfloat16)}
    pt = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    zj = {"w": jnp.zeros((16, 32))}
    zt = lambda: {"w": torch.zeros(16, 32)}     # noqa: E731
    h = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    want = r_opt.adamw_update(pj, {"w": jnp.asarray(g)}, zj, zj, jnp.asarray(1),
                              r_opt.AdamWHyper(**h))[0]["w"]
    got = adamw_update(pt, {"w": torch.from_numpy(g)}, zt(), zt(), torch.tensor(1),
                       AdamWHyper(**h))[0]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(host(got), host(want))


@pytest.mark.parametrize("seed", range(4))
def test_compress_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(4096) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    err = (rng.standard_normal(4096) * 1e-2 * np.abs(g).max()).astype(np.float32)
    g[:5] = [0.5, -0.5, 1.5, 2.5, -2.5]      # ties, rounded half to even
    qj, sj, ej = r_opt.compress_int8(jnp.asarray(g), jnp.asarray(err))
    qt, s_t, et = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(host(s_t), host(sj), rtol=1e-6)
    np.testing.assert_allclose(host(et), host(ej), rtol=1e-6, atol=1e-6 * float(host(sj)))
    np.testing.assert_allclose(host(decompress_int8(qt, s_t)), host(r_opt.decompress_int8(qj, sj)),
                               rtol=1e-6)
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]) * 1.0
    q, s, _ = compress_int8(half * (127 / 2.5), torch.zeros(5))
    assert q.tolist() == [25, 76, 127, -25, -127]


# ----------------------------------------------------------- train step

ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _step_pair(rcfg, pcfg, ref, port, accum, compress):
    """(reference jitted step, its state, port step, its state), the states
    equal: the reference's params, zero moments (and residual), step 0."""
    rh = RefTrainHyper(adamw=r_opt.AdamWHyper(**ADAMW), grad_accum=accum, compress_grads=compress)
    ph = TrainHyper(adamw=AdamWHyper(**ADAMW), grad_accum=accum, compress_grads=compress)
    zeros = lambda t: np.zeros(t.shape, np.float32)     # noqa: E731
    r_state = {"params": ref, "m": jax.tree.map(zeros, ref), "v": jax.tree.map(zeros, ref),
               "step": np.int32(0)}
    if compress:
        r_state["err"] = jax.tree.map(zeros, ref)
    p_state = {"params": _tree.tree_map(torch.clone, port), **{
        k: _tree.tree_map(lambda a: torch.from_numpy(np.array(a)), v)
        for k, v in r_state.items() if k != "params"}}
    spec_def = _tree.flatten(_tree.tree_map(lambda s: 0, train_state_specs(pcfg, ph),
                                            is_leaf=lambda x: isinstance(x, ParamSpec)))[1]
    assert str(_tree.flatten(p_state)[1]) == str(spec_def)
    return jax.jit(r_make_train_step(rcfg, rh)), r_state, make_train_step(pcfg, ph), p_state


def _run_steps(rcfg, pcfg, r_step, r_state, p_step, p_state, tol):
    """3 steps of each on the same batches (4 x 16, seeds 30-32); loss and
    grad_norm within ``tol``, lr within 1e-6, the state updated in place."""
    for i in range(3):
        r_state, r_m = r_step(r_state, r_make_batch(rcfg, 4, L, seed=30 + i))
        state_in = p_state
        p_state, p_m = p_step(p_state, make_batch(pcfg, 4, L, seed=30 + i, device="cpu"))
        assert p_state is state_in
        np.testing.assert_allclose(host(p_m["loss"]), host(r_m["loss"]), rtol=tol)
        np.testing.assert_allclose(host(p_m["grad_norm"]), host(r_m["grad_norm"]), rtol=tol)
        np.testing.assert_allclose(host(p_m["lr"]), host(r_m["lr"]), rtol=1e-6)
    assert p_state["step"].dtype == torch.int32 and int(p_state["step"]) == int(r_state["step"]) == 3
    return r_state, p_state


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum, models):
    """3 steps of ``make_train_step`` from one carried state (reduced
    h2o-danube-1.8b, float32) against the reference's jitted step: loss,
    grad_norm and lr each step, then m, v and the parameter update
    p - p0, each leaf as ``grad_share`` measures it. The gradients carry the
    model's E2E_TOL (2e-3); m (0.1 g per step) carries it, v (0.05 g^2)
    twice it, and the update follows m / sqrt(v)."""
    rcfg, pcfg, ref, port = models("h2o-danube-1.8b")
    tol = E2E_TOL["h2o-danube-1.8b"]
    r_state, p_state = _run_steps(rcfg, pcfg, *_step_pair(rcfg, pcfg, ref, port, accum, False),
                                  tol)
    ref_upd = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), r_state["params"], ref)
    port_upd = _tree.tree_map(lambda a, b: a - b, p_state["params"], port)
    for name, got, want, bound in (("m", p_state["m"], r_state["m"], tol),
                                   ("v", p_state["v"], r_state["v"], 2 * tol),
                                   ("update", port_upd, ref_upd, tol)):
        share, i = grad_share(_tree.leaves(got), jax.tree.leaves(jax.device_get(want)), bound)
        path = _tree.keystr(_tree.flatten_with_path(got)[0][i][0])
        assert share <= 1.0, f"{name}: {path} at {share:.3g} of {bound}"


@pytest.mark.parametrize("accum", [1, 2])
def test_compressed_train_step_matches_reference(accum, models, monkeypatch):
    """``compress_grads``: 3 steps against the reference's jitted step, with
    ``loss_fn`` replaced in both packages by the linear loss
    ``s(batch) * sum_leaf <c_leaf, p_leaf>`` (``c`` drawn once from numpy,
    ``s`` the micro-batch's mean token over the vocabulary), whose gradient
    ``s * c`` both compute bit for bit. The int8 rounding is discontinuous:
    with the model's gradients, 1e-4 apart, elements near a half step round
    apart and move the residual by a whole step, putting err 31-123 times
    outside the gradient's bound after one step from a common state. On
    equal gradients the accumulation, quantisation, residual and update
    must agree (a rounding apart would put err a whole step, twice its
    largest value, away):

    * params within the optimizer's 1e-6;
    * m and v within 1e-5: they follow the clip scale, whose norm of about
      2e5 float32 squares the packages sum in other orders (about 1e-6
      apart; v doubles it);
    * err within 1e-4 of its largest value: ``gf - q * scale`` cancels up
      to 8 bits (|gf| reaches 127 steps, |err| stays under half of one),
      so one rounding of it (or XLA's fused multiply-add) moves it by up
      to 2^8 * 2^-24 = 1.5e-5 of its largest value, carried over 3 steps.
    """
    import repro.train.step as r_step_mod
    import repro_torch.train.step as p_step_mod
    rcfg, pcfg, ref, port = models("h2o-danube-1.8b")
    rng = np.random.default_rng(50)
    coef = [rng.standard_normal(np.shape(x)).astype(np.float32) for x in jax.tree.leaves(ref)]
    coef_j = [jnp.asarray(c) for c in coef]
    coef_t = [torch.from_numpy(c) for c in coef]
    V = float(rcfg.vocab_size)

    def r_linear(cfg, params, batch, remat=True):
        s = jnp.mean(batch["tokens"].astype(jnp.float32)) / V
        loss = s * sum(jnp.sum(c * p) for c, p in zip(coef_j, jax.tree.leaves(params)))
        return loss, {"ce": loss, "aux": jnp.zeros(())}

    def p_linear(cfg, params, batch, remat=True):
        s = batch["tokens"].float().mean() / V
        loss = s * sum((c * p).sum() for c, p in zip(coef_t, _tree.leaves(params)))
        return loss, {"ce": loss, "aux": torch.zeros(())}
    monkeypatch.setattr(r_step_mod, "loss_fn", r_linear)
    monkeypatch.setattr(p_step_mod, "loss_fn", p_linear)
    r_state, p_state = _run_steps(rcfg, pcfg, *_step_pair(rcfg, pcfg, ref, port, accum, True),
                                  1e-5)
    for name, tol in (("params", 1e-6), ("m", 1e-5), ("v", 1e-5), ("err", 1e-4)):
        close_tree(p_state[name], jax.device_get(r_state[name]), tol)


def test_grad_accum_sums_micro_batches_in_order(models, monkeypatch):
    """accum 2 on a batch of 4 hands the optimizer the two 2-row halves'
    grads summed in float32 from zero, then halved; its loss is the halves'
    mean."""
    import repro_torch.train.step as step_mod
    _, pcfg, _, port = models("h2o-danube-1.8b")
    batch = make_batch(pcfg, 4, L, seed=40, device="cpu")
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    parts = [loss_and_grads(pcfg, port, h) for h in halves]
    want = [(a.float() + b.float()) / 2 for a, b in zip(parts[0][2], parts[1][2])]
    seen = {}

    def grab(params, grads, m, v, step, h):
        seen["grads"] = [g.clone() for g in grads]
        return params, m, v, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}
    monkeypatch.setattr(step_mod, "adamw_update", grab)
    state = {"params": port, "m": None, "v": None, "step": torch.zeros((), dtype=torch.int32)}
    _, mets = make_train_step(pcfg, TrainHyper(grad_accum=2))(state, batch)
    assert len(seen["grads"]) == len(want)
    for g, w in zip(seen["grads"], want):
        assert torch.equal(g, w)
    assert torch.equal(mets["loss"], (0.0 + parts[0][0] + parts[1][0]) / 2)
    assert int(state["step"]) == 1
    with pytest.raises(ValueError, match="multiple of grad_accum"):
        make_train_step(pcfg, TrainHyper(grad_accum=3))(state, batch)


# --------------------------------------- the reference's tests on the port
# tests/test_train_extras.py, its non-sharding cases, with jnp -> torch

def test_adamw_decreases_quadratic_loss():
    h = AdamWHyper(lr=0.1, warmup_steps=0, total_steps=1000, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    m = {"w": torch.zeros(3)}
    v = {"w": torch.zeros(3)}
    for i in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw ||w||^2
        params, m, v, _ = adamw_update(params, grads, m, v, torch.tensor(i), h)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_grad_clip_applies():
    h = AdamWHyper(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.ones(4)}
    big = {"w": torch.full((4,), 1e6)}
    _, _, _, metrics = adamw_update(params, big, {"w": torch.zeros(4)},
                                    {"w": torch.zeros(4)}, torch.tensor(0), h)
    assert float(metrics["grad_norm"]) > 1e5     # reported pre-clip


@given(step=st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_cosine_lr_bounds(step):
    h = AdamWHyper(lr=3e-4, warmup_steps=100, total_steps=10_000)
    lr = float(cosine_lr(h, torch.tensor(step, dtype=torch.float32)))
    assert 0.0 <= lr <= h.lr + 1e-9


@given(seed=st.integers(0, 2**16), scale=st.floats(1e-3, 1e3))
@settings(max_examples=30, deadline=None)
def test_int8_error_feedback_contract(seed, scale):
    """decompress(compress(g)) + err' == g + err (no information lost)."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal(256) * scale).astype(np.float32))
    err = torch.from_numpy((rng.standard_normal(256) * scale * 0.01).astype(np.float32))
    q, s, new_err = compress_int8(g, err)
    assert q.dtype == torch.int8
    recon = decompress_int8(q, s)
    np.testing.assert_allclose((recon + new_err).numpy(), (g + err).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_int8_error_feedback_converges():
    """Accumulated error feedback keeps the long-run mean unbiased."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    err = torch.zeros(64)
    total = torch.zeros(64)
    N = 200
    for _ in range(N):
        q, s, err = compress_int8(g_true, err)
        total = total + decompress_int8(q, s)
    np.testing.assert_allclose((total / N).numpy(), g_true.numpy(), atol=2e-2)


def test_compressed_training_still_learns():
    """EF-int8 gradient round-trip in the train step keeps training sane:
    loss trajectory close to the uncompressed run."""
    cfg = get_reduced("h2o-danube-1.8b")
    batches = [make_batch(cfg, 2, 32, seed=i, device="cpu") for i in range(6)]

    def run(compress):
        hyper = TrainHyper(compress_grads=compress)
        state = init_params(train_state_specs(cfg, hyper), 0, "cpu")
        step = make_train_step(cfg, hyper)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses

    plain = run(False)
    comp = run(True)
    assert comp[-1] < comp[0]                       # still learning
    assert abs(comp[-1] - plain[-1]) < 0.25          # close trajectory


# tests/test_checkpoint.py::test_preemption_exact_resume, on the port

def _small_store():
    return ZonedCheckpointStore(num_zones=8, zone_bytes=4 * 1024 * 1024, keep=2,
                                torch_device="cpu")


def _assert_tree_equal(a, b):
    la, lb = _tree.leaves(a), _tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_preemption_exact_resume():
    """train 6 steps straight == train 3, 'crash', resume, train 3 more."""
    cfg = get_reduced("h2o-danube-1.8b")
    rng = np.random.default_rng(0)
    batches = [
        {"tokens": rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)}
        for _ in range(6)
    ]
    tcfg = TrainerConfig(total_steps=6, checkpoint_every=3, log_every=100,
                         hyper=TrainHyper())
    # uninterrupted
    t1 = Trainer(cfg, tcfg, device="cpu")
    t1.run(iter(list(batches)))
    # interrupted at step 3
    store = _small_store()
    t2 = Trainer(cfg, TrainerConfig(total_steps=3, checkpoint_every=3,
                                    log_every=100), store=store, device="cpu")
    t2.run(iter(list(batches)))
    assert store.latest_step() == 3
    # the same checkpoint for a resume that does not replay the pipeline
    fault_store = _small_store()
    fault_store.save(3, store.restore(like=abstract_params(train_state_specs(cfg))))
    fault_store.flush()
    t3 = Trainer(cfg, tcfg, store=store, device="cpu")   # resumes at 3, replays pipeline
    t3.run(iter(list(batches)))
    assert int(t3.state["step"]) == 6
    assert t3.state["step"].dtype == torch.int32
    _assert_tree_equal(t1.state["params"], t3.state["params"])
    _assert_tree_equal(t1.state["m"], t3.state["m"])
    _assert_tree_equal(t1.state["v"], t3.state["v"])
    # without the replay it trains steps 3-5 on batches 0-2 and lands elsewhere
    t4 = Trainer(cfg, tcfg, store=fault_store, device="cpu")
    t4.run(iter(list(batches[:3]) + list(batches)))
    assert int(t4.state["step"]) == 6
    assert not torch.equal(t4.state["params"]["embed"]["tok"], t1.state["params"]["embed"]["tok"])


def test_resume_onto_the_trainer_device_from_meta_like():
    """``init_or_resume`` restores with meta-tensor ``like`` onto the
    trainer's device; a fresh state comes from ``init_params(seed)``."""
    cfg = get_reduced("h2o-danube-1.8b")
    tr = Trainer(cfg, TrainerConfig(total_steps=1, checkpoint_every=1, seed=3),
                 store=_small_store(), device="cpu")
    assert tr.init_or_resume() == 0
    fresh = init_state(cfg, 3, device="cpu")
    _assert_tree_equal(tr.state, fresh)
    tr.save()
    again = Trainer(cfg, TrainerConfig(total_steps=1), store=tr.store, device="cpu")
    assert again.init_or_resume() == 0
    assert all(t.device.type == "cpu" for t in _tree.leaves(again.state))
    _assert_tree_equal(again.state, fresh)


# ------------------------------------------------------------------- CLI

def test_launch_train_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch
    ckpt = str(tmp_path / "ckpt.zns")
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2", "--seq", "16",
            "--checkpoint-every", "3", "--device", "cpu", "--ckpt", ckpt]
    assert launch.main(argv + ["--steps", "3"]) == 0
    assert "[launch] done: loss=" in capsys.readouterr().out
    run = launch.build(launch.parse_args(argv + ["--steps", "5"]))
    run.trainer.run(run.batches)
    assert [h["step"] for h in run.trainer.history] == [3, 4]
    assert int(run.trainer.state["step"]) == 5 and run.ckpt.latest_step() == 5
    assert all(math.isfinite(h["loss"]) for h in run.trainer.history)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_ckpt_geometry_holds_the_state(arch):
    """The launcher's checkpoint store at each arch's published size: every
    leaf fits one zone, and the payload zones hold keep + 1 train states
    (a save lands before GC), each packed into at most twice the zones its
    bytes fill."""
    from repro_torch.launch import train as launch
    cfg = get_config(arch)
    zones, zone = launch.ckpt_geometry(cfg, keep=2)
    sizes = [math.prod(sp.shape) * sp.dtype.itemsize for sp in _tree.flatten(
        train_state_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))[0]]
    assert zone % launch.BLOCK_BYTES == 0 and zone >= max(max(sizes), launch.ZONE_BYTES)
    assert (zones - 1) * zone >= 3 * 2 * sum(sizes)
    if arch == "h2o-danube-1.8b":     # float32 embedding moments of 328 MB
        assert zone >= 32000 * 2560 * 4


def test_launch_train_refuses_a_mesh():
    from repro_torch.launch import train as launch
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        launch.build(launch.parse_args(["--reduced", "--data", "2", "--device", "cpu"]))


# -------------------------------------------------------------- devices

def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import train as launch
    cfg = get_reduced("h2o-danube-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.build(launch.parse_args(["--reduced"]))
    assert init_state(cfg, 0, device="cpu")["step"].device.type == "cpu"
