"""The zoned decode on the card: ``ServeModel.decode_sessions`` replays one
captured CUDA graph a step (``ZonedStepGraph``), and its logits and the K/V
it leaves in the zones must be the eager ``decode_step``'s over the same
cache, step after step, through an eviction and an admission.

Run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_zoned_decode_card.py``; without a Hopper card the test
skips (a CUDA graph has no CPU mode). No JAX in this file.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels.paged_attn.kernel import paged_attention_kernel
from repro_torch.models import decode_step, init_params, param_specs
from repro_torch.serve import KVZoneCache, ServeModel
from repro_torch.serve.step import ZonedStepGraph


def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper card: the step is a CUDA graph and the paged "
                    "kernel has no CPU mode")


@pytest.mark.cuda
def test_the_graph_replays_the_eager_step():
    card()
    cfg = get_reduced("granite-8b").replace(head_dim=64, num_heads=8, num_kv_heads=2,
                                            d_model=256)
    m = ServeModel(cfg, init_params(param_specs(cfg), 3, "cuda"), device="cuda")

    def new_cache():
        return KVZoneCache(num_layers=cfg.num_layers, num_zones=64, zone_len=16,
                           kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                           max_zones_per_seq=8, device="cuda")
    graphed, eager = new_cache(), new_cache()
    rng = np.random.default_rng(0)
    prompts = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
               for k, n in ((0, 37), (1, 16), (2, 50), (3, 21))}
    for c in (graphed, eager):
        for k in (0, 1, 2):
            m.admit(c, [k], {"tokens": prompts[k]})
    rows = [0, 1, 2]
    for t in range(12):
        evict, admit = (), ()
        if t == 6:
            _, k, v = m.prompt_kv({"tokens": prompts[3]})
            evict, admit, rows = (1,), ((3, k[:, 0], v[:, 0]),), [0, 3, 2]
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).cuda()
        before = paged_attention_kernel.launches
        _, got = m.decode_sessions(graphed, rows, tok, evict=evict,
                                   admit=copy.copy(admit))
        # the first step runs eagerly once before its graph is captured
        assert paged_attention_kernel.launches - before == cfg.num_layers * (2 if t == 0 else 1)
        for sid in evict:
            eager.evict(sid)
        for sid, k, v in admit:
            eager.admit(sid, k, v)
        step = eager.reserve(rows)
        want, _ = decode_step(cfg, m.tree(), step, tok, step.positions)
        torch.testing.assert_close(got, want)          # bf16's default tolerance
    assert isinstance(m._graph, ZonedStepGraph) and m._graph.cache is graphed
    torch.testing.assert_close(graphed.k, eager.k)
    torch.testing.assert_close(graphed.v, eager.v)
