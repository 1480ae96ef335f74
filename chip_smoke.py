#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failed phase exits non-zero:

  device    the card's name, compute capability (must be 9.0) and power limit
  build     nvcc of every kernel source, all started together (seconds, or
            "cached"), with registers and spills for each source
  kernels   every kernel held against its plain PyTorch version on the card.
            zone_filter: every (dtype, kind), the reference tests' programs
            and the edge programs, at 64 and 65,536 pages; batched rows
            against single launches. Exact for counts, integers, min and max;
            float sums within rtol 1e-5 of the sum of the magnitudes they add.
            Batched rows at 8 x 2,048 pages (float sums within rtol 1e-5
            of each row's sum) and at the array's 512 x 64 (of each row's
            summed magnitudes: a 65,536-value row of mixed signs may sum
            near zero). Float sums bit for bit at the 256 KiB chunk and the
            256 MiB zone, bare and through a program: a single launch, a
            batched row, repeats and two streams at once, one launch a
            wrapper call; rows of the array's 512 x 64 dispatch (4 fold
            blocks a CUDA block) against each chunk alone; planted faults
            must fail that check: a stale ticket (no block folds) and a
            ticket one short of the block count (the first block to arrive
            folds before the other partials are in: a finite wrong sum).
            paged_attn: the reference tests' geometries, every attention
            geometry of src/repro/configs, one geometry of several splits
            and the granite-8b pool, in float32 and bfloat16 (within
            PAGED_TOL), each at kernel.py::plan's split and at one split a
            row, on random tables with -1 tails, ragged and full lengths, a
            length-0 row, an all -1 row, a -1 hole, and rows at the
            kernel's split boundaries; each plan's shared memory against
            the kernel's own.
  offload   the paper's Figure 2 offload through NvmCsd: one 256 MiB zone of
            random int32, count > RAND_MAX/2, on the kernel and jit tiers
            (interp on a 4 MiB zone); launch counts read around the run
  array     the same zone striped over a StripedZoneArray and offloaded
            through OffloadScheduler on the kernel tier: raid0 at widths 1,
            2, 4 and 8, and xor at width 4 with member 1 offline (its chunks
            reconstructed on the host and run one by one); 256 KiB chunks
            in 2 groups of 512, one batched launch a group. Each count
            against numpy's and NvmCsd's; the dispatches, launches and
            host-to-card copies and bytes against the plan's arithmetic;
            a partial extent's tail chunk at width 4
  batched   the chunk-batched kernel entry over the same zone as 8 chunks
  serve     zoned-KV decode through KVZonePool at granite-8b width on a
            4,096-zone bf16 pool: two waves of sequences, an eviction between
            them and zone reuse; every attend held against the plain version,
            and two planted faults (a length one short, a last zone dropped)
            that this check must reject
  pipeline  the training-data pushdown through ZoneDataPipeline on the jit
            tier: a 4 x 256 MiB corpus of 2,048-token records (granite-8b
            vocabulary, quality in [0, 100)) filtered at quality >= 50 by
            NvmCsd, each zone's count and records against numpy's, the first
            batches of an epoch against numpy's recomputation, the histograms
            and PipelineStats against the arithmetic; then the same corpus on
            a raid0 x 4 StripedZoneArray (768 KiB chunks) through
            OffloadScheduler, whose records must be the same. No zone_filter
            kernel may launch: these programs project a field, which the
            kernel tier does not take
  checkpoint one granite-8b layer's train state (bf16 params, f32 AdamW
            moments, 2.18 GB on the card) through ZonedCheckpointStore on 24
            zones of 256 MiB: save, save again (with gc), restore onto the
            card (every leaf torch.equal), a cold reopen, and a flipped
            payload byte that the restore must refuse while the older step
            still restores; then the reference's raid1 power-loss sweep over
            card tensors, every boundary ok
  model     the model serve stack: granite-8b at its published widths and
            depth (36 layers, bf16, 8.26 B random parameters) serving 8
            prompts of 1,024 tokens with 32 greedy tokens each through
            ServeModel.generate: prefill and decode-step times (CUDA events)
            beside their bounds, tokens/s, peak memory; every step's logits
            against a teacher-forced forward within MODEL_LOGIT_LIMIT, and a
            planted late decode that check must reject. Then float32 at
            published widths, depth cut to one superblock, for every
            architecture of src/repro/configs: decode against forward at
            2e-3 where the reference's tests run it, granite's prefill then
            decode at 5e-3 and its card forward against the CPU's at 2e-3,
            shapes and finite values elsewhere. No kernel of the port runs
  train     the training path: h2o-danube-1.8b at its published widths and
            depth (24 layers, bf16, 1.83 B random parameters) through
            launch/train.py's wiring (a zoned corpus of 4,097-token records,
            ZoneDataPipeline, PrefetchLoader, Trainer): 4 x 4,096 tokens a
            step in 2 micro-batches, one warm-up and 3 timed steps (CUDA
            events, host clock beside), tokens/s, peak memory, beside the
            bound, and one step under the profiler. Held: finite losses and
            grad norms, the first loss in (0.1, 3 ln V); at two layers a
            lower loss after 4 steps on one repeated batch (at 24 the
            reference's initialisation makes the gradient explode, so
            there it is reported); at one layer in float32
            the card's gradients and updated state against the CPU's
            within GRAD_TOL per leaf, and a leaf's gradient scaled by
            1 + GRAD_FAULT that this check must reject; the update itself
            within UPDATE_TOL where the gradient is above a floor at
            which no sign can differ (an update scaled by 1 + GRAD_FAULT
            must fail);
            at one layer in bf16 the card's gradient against the CPU's
            within BF16_TOL or twice the CPU's own bf16 error (a planted
            fault must fail); at two layers the
            reference's exact-resume case through ZonedCheckpointStore,
            bit for bit under deterministic algorithms, and a resume that
            does not replay the pipeline, which must differ. No kernel of
            the port runs
  mesh      the device mesh on a world-size-1 NCCL group and a 1 x 1
            ("data", "model") DeviceMesh (make_local_mesh): h2o-danube-1.8b
            at the train phase's shape, the sharded Trainer's first step
            (every leaf handed to it a DTensor on the card) against the
            unsharded one's (loss rtol 2e-2; every leaf within 5e-2
            elementwise and of its norm; a scaled leaf must fail), a
            second step profiled; granite-8b's decode, 8 steps over DTensor
            params and cache under the decode rules, against
            ServeModel.generate's greedy tokens and logits (a step whose
            cache write is skipped must fail); the checkpoint phase's layer
            state restored with shardings= onto the mesh bit for bit; a
            one-stage pipeline_apply. No collective crosses between cards,
            and no kernel of the port runs
  timing    kernel, plain-version and library times on the card (CUDA events),
            with the device kernels one call runs and their launches a call
            (torch.profiler; 1 for a zone-filter row, 2 for the paged row,
            held); the paged row with its plan (splits, CTAs, shared
            memory) and the registers and spills of the paged_partial
            instance it runs. It runs right after the build: torch.profiler
            sees every kernel early in a process, not late (profiled_ms)

Then the ``nvidia-smi`` line, the kernel table as one JSON object, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
around it, it exits non-zero and prints no result.
"""
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RAND_MAX = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 700 W (NVIDIA data sheet)
VECTOR_OPS_PER_S = 67e12       # H100 SXM non-tensor float32 rate, used for ALU ops
PAGE_BYTES = 4096
DEVICE = "cuda"
CHECK_PAGES = (64, 65536)       # kernel checks: a small zone and a 256 MiB one
BATCH_SHAPES = ((8, 2048), (512, 64))   # chunks x pages: 8 chunks, the array's dispatch
ZONE_BYTES = 256 * 1024 * 1024  # the Figure 2 zone
INTERP_ZONE_BYTES = 4 * 1024 * 1024
ARRAY_STRIPE = 64               # blocks a chunk: 256 KiB (benchmarks/bench_array.py:42)
# (redundancy, members, member taken offline)
ARRAY_RUNS = (("raid0", 1, None), ("raid0", 2, None), ("raid0", 4, None),
              ("raid0", 8, None), ("xor", 4, 1))
ARRAY_TAIL_BLOCKS = 32          # a partial extent ends this far before the zone's end

# Attention geometries (H, KV, hd) of every attention model in
# src/repro/configs: granite-8b and llama-3.2-vision-11b, starcoder2-3b,
# h2o-danube-1.8b, recurrentgemma-9b, seamless-m4t-large-v2,
# command-r-plus-104b, deepseek-moe-16b, grok-1-314b.
CONFIG_GEOMETRIES = ((32, 8, 128), (24, 2, 128), (32, 8, 80), (16, 1, 256),
                     (16, 16, 64), (96, 8, 128), (16, 16, 128), (48, 8, 128))
# (B, H, KV, hd, NZ, ZL, MZ) of tests/test_kernels.py:145-149
TEST_GEOMETRIES = ((1, 4, 4, 32, 4, 16, 2), (2, 8, 2, 64, 8, 32, 3),
                   (4, 8, 1, 128, 16, 128, 4))
# every geometry above is one split of the kernel (kernel.py::plan: a split
# holds at least 256 slots); this one has three at a small ZL (16 zones a
# split), so the small head widths and the edge rows reach the combine as
# the granite pool's do
SPLIT_GEOMETRY = (8, 8, 2, 64, 64, 16, 48)
EDGE_ROWS = 8                   # paged_tables(edges=True) sets rows 0..7
# granite-8b (src/repro/configs/granite_8b.py) in its compute dtype, bf16:
# one layer's pool for 64 sequences at a 4K context, with spare zones
GRANITE = dict(num_zones=4096, zone_len=128, kv_heads=8, head_dim=128,
               max_zones_per_seq=64)
GRANITE_HEADS = 32
# (atol, rtol) of the paged_attn checks: |kernel - ref.py| <= atol + rtol *
# |ref.py| everywhere. Both compute in float32 from the same inputs, so in
# float32 they differ by the order of the sums (3.6e-6 at most on an H100),
# and in bfloat16 the two float32 results may also round to neighbouring
# bfloat16 values, one step apart: at most 2**-7 of the value.
PAGED_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2**-7)}
# the pipeline phase's corpus: zones x 256 MiB of records [quality | 2,048
# tokens | padding to 3 pages], tokens in granite-8b's vocabulary
PIPE_ZONES = 4
PIPE_SEQ = 2048
PIPE_VOCAB = 49152              # src/repro/configs/granite_8b.py
PIPE_MIN_QUALITY = 50
PIPE_BATCH = 8
PIPE_BATCHES_CHECKED = 16
PIPE_STRIPE = 192               # blocks: 768 KiB chunks, a multiple of the record's 3 pages
PIPE_MEMBERS = 4
SEED = 0
# the checkpoint phase: one granite-8b layer (d_model, heads, kv heads,
# head_dim, d_ff) with its AdamW moments, on zones of 256 MiB
CKPT_DIMS = (4096, 32, 8, 128, 14336)
CKPT_ZONES = 24
CKPT_ZONE_BYTES = 256 * 1024 * 1024
# the model phase: granite-8b (src/repro/configs/granite_8b.py) at its
# published widths and depth in bf16, random weights from init_params(seed
# 0), served by ServeModel.generate: 8 prompts of 1,024 tokens, 32 new
# tokens each (the first from the prefill, then 31 decode steps)
MODEL_ARCH = "granite-8b"
MODEL_BATCH, MODEL_PROMPT, MODEL_NEW = 8, 1024, 32
MODEL_FAULT_NEW = 4             # tokens of the planted late-decode run
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
# |decode logits - teacher-forced forward logits|, any logit, at the serve
# shape cut to one layer (held_check). Both paths run the same bf16 layer
# and round in different places (other GEMM shapes; one softmax against two
# attention chunks), each at most one bf16 step apart. The logits are bf16
# below 8 in magnitude (checked), where a step is 2^-5, so the logit's own
# rounding in each path gives up to 2 steps and the hidden state's
# differences, at most one step in some of its 4,096 elements, add well
# under one more through the final norm and head: 4 steps, 0.125
# (PERF.md, the model cell). At 36 layers the reference's initialisation
# makes the function ill-conditioned and the comparison is reported, not held.
MODEL_LOGIT_LIMIT = 0.125
CONDITIONING_DEPTHS = (2, 4)    # layers at which decode vs forward is also reported
# the exact checks: float32, published widths, depth cut to one superblock
EXACT_T = 12
EXACT_LAYERS = {
    "granite-8b": {"num_layers": 2},
    "h2o-danube-1.8b": {"num_layers": 1},           # sliding window
    "starcoder2-3b": {"num_layers": 1},             # LayerNorm, GELU, bias
    "command-r-plus-104b": {"num_layers": 1},       # parallel block, tied head
    "deepseek-moe-16b": {"num_layers": 2},          # dense layer 0, then MoE
    "grok-1-314b": {"num_layers": 1},               # MoE, softcap
    "mamba2-780m": {"num_layers": 1},
    "recurrentgemma-9b": {"num_layers": 3},         # rglru, rglru, local_attn
    "llama-3.2-vision-11b": {"num_layers": 5},      # cross layer included
    "seamless-m4t-large-v2": {"num_layers": 1, "encoder_layers": 1},
}
# the card's float32 forward against the CPU's, the same weights (granite-8b,
# 2 layers): the bound the reference's tests hold two evaluation orders of
# one float32 model to (decode against forward). cuBLAS and the CPU's BLAS
# sum in other orders, and the reference's initialisation makes attention
# hard (layer-0 logits of std about 255, the two largest of a query as
# close as 0.019), so the two read 1.2e-4 apart at one layer and 2.1e-3 at
# two on an H100 (PERF.md, the model cell)
CARD_VS_CPU_TOL = 2e-3
# tests/test_arch_smoke.py: the archs whose decode the reference holds to
# its forward at 2e-3
DECODE_CONSISTENCY_ARCHS = (
    "h2o-danube-1.8b", "starcoder2-3b", "granite-8b", "command-r-plus-104b",
    "grok-1-314b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b",
)
# the train phase: h2o-danube-1.8b (src/repro/configs/h2o_danube_1_8b.py) at
# its published widths and depth (24 layers, 1.83 B parameters), bf16,
# random weights from init_params(seed 0), through launch/train.py's wiring:
# sequences of 4,096 tokens (train_4k's length), 4 a step in 2 micro-batches
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 4096, 4, 2
TRAIN_STEPS = 4                 # one warm-up step, then 3 timed
TRAIN_LR = 3e-4
TRAIN_REPEAT = 4                # steps on one repeated batch (the loss check, two layers)
# gradients, card against CPU: one layer, float32, TF32 off, 2 x 256 tokens,
# each leaf's relative L2 error. float32 against float64 reads at most about
# 9e-5 at this shape on either device (the attention-score leaves: tok, wq,
# wk, ln1; the train line's f32_vs_f64_max_relative), so two float32
# evaluation orders differ by up to about 1.8e-4; 1e-3 leaves room for other
# summation orders (the one-layer forward read 1.01x of 1e-4 elementwise),
# and a leaf scaled by 1 + GRAD_FAULT lands near 10 (PERF.md, the train cell)
GRAD_CHECK = dict(num_layers=1, batch=2, seq=256)
GRAD_TOL = 1e-3
GRAD_FAULT = 1e-2
# the update p - p0 of that step, held where the CPU's gradient is above a
# floor of its leaf's rms. If each float32 gradient of a leaf lies within n
# rms of the float64 one elementwise (n measured on both devices), no
# element above 2 n rms can take another sign on the other device: the
# floor is 4 n, and at least UPDATE_FLOOR. AdamW's first steps move an
# element by about lr whatever its size, and the sign decides the
# direction. Above the floor the update differs only where p - lr * delta
# rounds to another float32: one ulp of a norm's scale (1.0) against an
# update of 2.2e-4 is 5e-4 of it, so UPDATE_TOL (relative L2) holds if every
# element rounded apart, and an update off by 1 + GRAD_FAULT lands near 10
UPDATE_FLOOR = 1e-2
UPDATE_TOL = 1e-3
# the same step's gradient in bfloat16 (the main path's dtype), card against
# CPU, one layer: each leaf within BF16_TOL (the port's bf16 module
# tolerance) or twice the CPU's own bf16 distance from the float32 gradient
# of the same bf16 weights, where that is larger (tests/test_torch_grads.py::
# bf16_share); a leaf zero in float32 (below 1e-6 of the whole) stays below
# BF16_NOISE of it; the planted fault scales a leaf by 1 + 10 x its bound
BF16_TOL, BF16_NOISE = 2e-2, 1e-3
# exact resume (tests/test_checkpoint.py::test_preemption_exact_resume):
# two layers (0.30 B parameters, a 3 GB train state), bf16, 2 x 4,096 tokens
RESUME_LAYERS, RESUME_BATCH, RESUME_STEPS = 2, 2, 6
# a leaf lies in one zone: the embedding's float32 moments are 328 MB
RESUME_ZONES, RESUME_ZONE_BYTES = 24, 512 * 1024 * 1024
# tests/test_faults.py::TestCrashHarness::test_raid1_sweep_never_torn
SWEEP = dict(num_devices=4, num_zones=6, member_zone_bytes=256 * 1024, stripe_blocks=4,
             redundancy="raid1")
# the mesh phase: a ("data", "model") mesh of 1 x 1 on a world-size-1 NCCL
# group. Training: TRAIN_ARCH at the train phase's shape, the sharded
# Trainer's first step against the unsharded one's at
# tests/test_sharding_small.py's bounds: loss rtol MESH_LOSS_RTOL, every leaf
# within rtol = atol = MESH_TOL elementwise and, since parameters of 0.02 and
# moments far below that pass any elementwise atol of 5e-2, within MESH_TOL
# of the leaf's norm (relative L2); a leaf scaled by 1 + MESH_FAULT must fail.
# Serving: MODEL_ARCH's MESH_NEW decode steps after the model phase's
# prefill shape, against ServeModel.generate's greedy tokens and logits
# (within MODEL_LOGIT_LIMIT); a decode step whose cache write is skipped must
# fail that bound
MESH_TRAIN_STEPS = 2
MESH_LOSS_RTOL, MESH_TOL, MESH_FAULT = 2e-2, 5e-2, 0.5
MESH_NEW = 8
MESH_PIPE = dict(n_micro=4, micro_batch=8, width=1024)
# one granite-8b layer's logical axes (granite_layer_state's tree), as
# src/repro/models/attention.py, common.py give them
LAYER_AXES = {"attn": {"wq": ("embed", "q_heads", "head_dim"),
                       "wk": ("embed", "kv_heads", "head_dim"),
                       "wv": ("embed", "kv_heads", "head_dim"),
                       "wo": ("q_heads", "head_dim", "embed")},
              "ln1": {"scale": ("embed",)}, "ln2": {"scale": ("embed",)},
              "mlp": {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
                      "down": ("mlp", "embed")}}


_T0 = time.perf_counter()


def emit(phase, **fields):
    """One JSON line; ``at_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _T0, **fields}),
          flush=True)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


# --------------------------------------------------------------- programs

def programs(tp):
    """(name, dtype, port Program) for the kernel checks: one per
    kernelizable (dtype, kind), tests/test_kernels.py:77-88,
    tests/test_hotpath.py:260-269 and the edge programs."""
    i32 = np.iinfo(np.int32)

    def P(name, dtype, *insns):
        return name, dtype, tp.Program(dtype, tuple(
            tp.Instruction(tp.OpCode(op), imm) for op, imm in insns), name=name)

    out = []
    for dtype in ("int32", "int64", "uint32", "float32", "float64"):
        thr = 0.5 if dtype.startswith("float") else 1000
        for kind in ("count", "sum", "min", "max"):
            if kind == "sum" and not dtype.startswith("float"):
                continue                    # int SUM goes to the jit tier
            out.append(P(f"{dtype}_gt_{kind}", dtype, ("cmp_gt", thr), (f"red_{kind}", None)))
    out += [
        P("fig2_count", "int32", ("cmp_gt", RAND_MAX // 2), ("red_count", None)),
        P("f32_le_count", "float32", ("cmp_le", 0.0), ("red_count", None)),
        P("mask_eq", "int32", ("and", 0xFF), ("cmp_eq", 7), ("red_count", None)),
        P("scaled_sum", "float32", ("mul", 2.0), ("cmp_ge", 10.0), ("red_sum", None)),
        P("abs_max", "int32", ("abs", None), ("red_max", None)),
        P("shift_min", "int32", ("shr", 3), ("cmp_gt", 1000), ("red_min", None)),
        P("lt_min", "int32", ("cmp_lt", 500), ("red_min", None)),
        P("mod_neg_divisor_min", "int32", ("mod", -3), ("red_min", None)),
        P("mod_on_negatives", "int32", ("cmp_lt", 0), ("mod", 7), ("cmp_eq", 6),
          ("red_count", None)),
        P("mod_minus_one", "int32", ("mod", -1), ("red_max", None)),
        P("mod_float", "float32", ("mod", -2.5), ("red_max", None)),
        P("shl33", "int32", ("shl", 33), ("red_max", None)),
        P("shl_wrap", "int32", ("shl", 31), ("red_min", None)),
        P("shr40_sign_fill", "int32", ("shr", 40), ("red_min", None)),
        P("abs_int_min", "int32", ("abs", None), ("red_min", None)),
        P("add_mul_wrap", "int32", ("add", i32.max), ("mul", 3), ("sub", -5),
          ("xor", 0x55), ("or", 1), ("red_max", None)),
        P("u32_max", "uint32", ("red_max", None)),
        P("u32_add_wrap", "uint32", ("add", 0xF0000000), ("cmp_gt", 2**31),
          ("red_count", None)),
        P("u32_mul_neg", "uint32", ("mul", 3), ("neg", None), ("red_max", None)),
        P("u32_shr_logical", "uint32", ("shr", 40), ("red_max", None)),
        P("u32_shr_mod", "uint32", ("shr", 3), ("mod", 1000), ("cmp_ne", 0),
          ("red_min", None)),
        P("i64_count", "int64", ("mul", 3), ("shr", 7), ("cmp_gt", 0), ("red_count", None)),
        P("i64_min", "int64", ("shl", 63), ("add", 2**40), ("red_min", None)),
        P("i64_max", "int64", ("abs", None), ("mod", -(2**50)), ("red_max", None)),
        P("f64_sum", "float64", ("cmp_gt", 0.0), ("red_sum", None)),
        P("f64_min", "float64", ("mul", 1e300), ("red_min", None)),
        P("f64_max", "float64", ("abs", None), ("neg", None), ("mod", 3.5), ("red_max", None)),
        P("f32_sum_all", "float32", ("red_sum", None)),
        P("empty_min_i32", "int32", ("cmp_gt", i32.max - 1), ("cmp_lt", 0), ("red_min", None)),
        P("empty_max_f32", "float32", ("cmp_gt", 1e30), ("red_max", None)),
        P("empty_min_f64", "float64", ("cmp_lt", -1e300), ("red_min", None)),
        P("empty_max_u32", "uint32", ("cmp_eq", 3), ("cmp_eq", 4), ("red_max", None)),
        P("empty_min_i64", "int64", ("cmp_ne", 0), ("cmp_eq", 0), ("red_min", None)),
    ]
    return out


def card_pages(torch, dtype, n_pages, seed):
    """Seeded pages made on the card: random bits for integer types (with
    INT_MIN, the maximum, 0 and small values up front), normal * 100 for
    floats (with 0 and +-0.5, +-7.25 up front)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = getattr(torch, dtype)
    elems = n_pages * PAGE_BYTES // torch.empty(0, dtype=tdt).element_size()
    if tdt.is_floating_point:
        x = torch.randn(elems, generator=g, device=DEVICE, dtype=tdt) * 100
        x[:4] = torch.tensor([0.0, -0.5, 7.25, -7.25], dtype=tdt)
    else:
        words = torch.randint(-2**31, 2**31 - 1, (elems * (8 if dtype == "int64" else 4) // 4,),
                              generator=g, device=DEVICE, dtype=torch.int32)
        x = words.view(tdt)
        if dtype == "uint32":
            small = torch.randint(0, 100, (1020,), generator=g, device=DEVICE,
                                  dtype=torch.int32).view(tdt)
            x[:1020] = small
        else:
            info = torch.iinfo(tdt)
            x[:3] = torch.tensor([info.min, info.max, 0], dtype=tdt)
            x[3:1024] = torch.randint(-50, 50, (1021,), generator=g, device=DEVICE, dtype=tdt)
    return x.reshape(n_pages, -1)


def as_f64(torch, t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64).bitwise_and(0xFFFFFFFF).to(torch.float64)
    return t.to(torch.float64)


def compare(torch, got, want, float_sum, magnitude=None):
    """(ok, max_abs_err). Exact unless ``float_sum``; then within 1e-5 of
    the summed magnitudes (rtol 1e-5 for sums of one sign)."""
    if got.dtype != want.dtype:
        return False, float("inf")
    g, w = as_f64(torch, got), as_f64(torch, want)
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    else:       # integers compared bit for bit (uint32 through its int32 view)
        bits = (lambda t: t.view(torch.int32)) if got.dtype == torch.uint32 else (lambda t: t)
        same = bits(got) == bits(want)
    err = torch.where(same, torch.zeros_like(g), (g - w).abs())
    max_err = float(err.max()) if err.numel() else 0.0
    if not float_sum:
        return bool(same.all()), max_err
    scale = w.abs() if magnitude is None else torch.maximum(w.abs(), magnitude)
    return bool((err <= 1e-5 * scale).all()), max_err


# ----------------------------------------------------------------- timing

def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / VECTOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases

def phase_device(torch):
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailed(f"nvidia-smi: {e}") from e
    lines = smi.stdout.strip().splitlines()
    smi_line = lines[0] if smi.returncode == 0 and lines else \
        f"nvidia-smi failed: {smi.stderr.strip()[:200]}"
    emit("device", name=name, capability=list(cap), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)
    check(smi.returncode == 0 and lines, "nvidia-smi gave no name and power limit")
    check(tuple(cap) == (9, 0), f"compute capability {cap}, need (9, 0) for sm_90a")
    return name, smi_line


def ptxas_report(log):
    """{kernel: [registers, spill-store bytes]} from nvcc's -Xptxas -v log.
    A kernel is named by its mangled name after the anonymous namespace,
    cut at the end of its template arguments."""
    kernels, name = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            ns = re.match(r"_ZN(\d+)", mangled)
            name = mangled[ns.end() + int(ns.group(1)):] if ns else mangled
            name = name.split("EEEv")[0][:48]
            if name in kernels:
                name = f"{name}#{len(kernels)}"
            kernels[name] = [0, 0]
        elif name and "bytes spill stores" in line:
            kernels[name][1] = int(line.split("bytes stack frame, ")[1].split()[0])
        elif name and "Used " in line and " registers" in line:
            kernels[name][0] = int(line.split("Used ")[1].split(" registers")[0])
    return kernels


def phase_build(kernel_modules, _build):
    """Build every kernel source at once, one nvcc each, from threads."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_modules)) as pool:
        failures = [f.exception() for f in
                    [pool.submit(m.load) for m in kernel_modules]]
    wall = time.perf_counter() - t0
    sources = {}
    for m, err in zip(kernel_modules, failures):
        stem = m.SOURCE.stem
        logs = sorted(_build.BUILD_DIR.glob(f"{stem}-*.log"), key=lambda p: p.stat().st_mtime)
        kernels = ptxas_report(logs[-1]) if logs else {}
        regs = [r for r, _ in kernels.values()]
        nvcc_s = _build.build_seconds.get(stem)
        sources[stem] = dict(nvcc_seconds=nvcc_s if nvcc_s is not None else "cached",
                             kernels_compiled=len(kernels),
                             max_registers=max(regs) if regs else None,
                             registers_by_kernel={k: r for k, (r, _) in kernels.items()},
                             spill_store_bytes={k: b for k, (_, b) in kernels.items() if b},
                             error=None if err is None else str(err)[-2000:])
    emit("build", load_seconds=wall, sources=sources)
    bad = [m.SOURCE.name for m, err in zip(kernel_modules, failures) if err is not None]
    check(not bad, f"build failed: {bad}")
    return sources


def phase_kernels(torch, tp, zf_kernel, zf_ops, zf_ref, pa_kernel, pa_ref):
    """Each kernel against its plain version; returns max_abs_err per kernel."""
    errs = {"filtered_reduce": 0.0, "filtered_reduce_batched": 0.0}
    failures, n_checks = [], 0
    cases = programs(tp)
    for n_pages in CHECK_PAGES:
        data = {d: card_pages(torch, d, n_pages, seed=n_pages + i) for i, d in
                enumerate(("int32", "int64", "uint32", "float32", "float64"))}
        # the bare kernel, every (dtype, kind) including integer sums
        for dtype, x in data.items():
            for kind in ("count", "sum", "min", "max"):
                got = zf_kernel.filtered_reduce(x, kind=kind)
                want = zf_ref.filtered_reduce_ref(x, kind)
                mag = as_f64(torch, x).abs().sum() if kind == "sum" else None
                ok, err = compare(torch, got, want, kind == "sum" and x.is_floating_point(), mag)
                errs["filtered_reduce"] = max(errs["filtered_reduce"], err)
                n_checks += 1
                if not ok:
                    failures.append(f"bare {dtype}/{kind}@{n_pages}: {got} vs {want}")
        for name, dtype, prog in cases:
            x = data[dtype]
            ops, imms = zf_ops.encode_program(prog, DEVICE)
            kind = zf_ops.TERM_KIND[prog.terminal.op]
            got = zf_kernel.filtered_reduce(x, kind=kind, ops=ops, imms=imms)
            transform = zf_ref.decode_transform(ops, imms, u32=dtype == "uint32")
            want = zf_ref.filtered_reduce_ref(x, kind, transform)
            float_sum = kind == "sum"
            mag = None
            if float_sum:
                vals, mask = transform(x.reshape(1, -1))
                mag = torch.where(mask, vals, 0).to(torch.float32).to(torch.float64).abs().sum()
            ok, err = compare(torch, got, want, float_sum, mag)
            errs["filtered_reduce"] = max(errs["filtered_reduce"], err)
            n_checks += 1
            if not ok:
                failures.append(f"{name}@{n_pages}: {got} vs {want}")
        del data
    # batched: each row equal to the single launch
    for i, ((name, dtype, prog), shape) in enumerate(
            (case, shape) for shape in BATCH_SHAPES for case in cases):
        x = card_pages(torch, dtype, shape[0] * shape[1], seed=100 + i).reshape(*shape, -1)
        ops, imms = zf_ops.encode_program(prog, DEVICE)
        kind = zf_ops.TERM_KIND[prog.terminal.op]
        rows = zf_kernel.filtered_reduce_batched(x, kind=kind, ops=ops, imms=imms)
        single = torch.stack([zf_kernel.filtered_reduce(c, kind=kind, ops=ops, imms=imms)
                              for c in x])
        transform = zf_ref.decode_transform(ops, imms, u32=dtype == "uint32")
        want = zf_ref.filtered_reduce_batched_ref(x, kind, transform)
        n_checks += 2
        same, _ = compare(torch, rows, single, False)
        if not same:
            failures.append(f"batched {name}@{shape}: rows {rows} vs single {single}")
        mag = None
        if kind == "sum" and shape == BATCH_SHAPES[0]:
            mag = as_f64(torch, want).abs()
        elif kind == "sum":     # each row's summed magnitudes, as the single checks
            vals, mask = transform(x.reshape(shape[0], -1))
            mag = torch.where(mask, vals, 0).to(torch.float32).to(torch.float64).abs().sum(1)
        ok, err = compare(torch, rows, want, kind == "sum", mag)
        errs["filtered_reduce_batched"] = max(errs["filtered_reduce_batched"], err)
        if not ok:
            failures.append(f"batched {name}@{shape} vs plain: {rows} vs {want}")
    identity = zone_filter_identity(torch, tp, zf_kernel, zf_ops, failures)
    n_checks += identity["checks"]
    paged_errs, paged_shares, paged_checks = paged_attention_checks(
        torch, pa_kernel, pa_ref, failures)
    errs["paged_attention"] = max(paged_errs.values())
    n_checks += paged_checks
    torch.cuda.synchronize()
    emit("kernels", checks=n_checks, zone_filter_bit_identity=identity,
         paged_attention_checks=paged_checks,
         paged_attention_max_abs_err=paged_errs,
         paged_attention_share_of_limit=paged_shares, failures=failures[:10],
         n_failures=len(failures), max_abs_err=errs)
    check(not failures, f"{len(failures)} kernel checks disagree with the plain version")
    return errs


def same_bits(torch, a, b):
    """Whether two float32 results are the same bits."""
    return torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def raw_filtered_reduce(torch, zf_kernel, x, ops, imms, bpc, ticket, partials):
    """One launch of ``zone_filter.cu`` over the float32 zone ``x`` (kind
    sum) through its C entry, with the partials ``partials`` (``bpc`` int64
    slots) and a ticket of its own that starts at ``ticket``; the result
    starts as NaN. Only the planted faults use it."""
    tickets = torch.full((1,), ticket, dtype=torch.int32, device=DEVICE)
    out = torch.full((), float("nan"), dtype=torch.float32, device=DEVICE)
    n = 0 if ops is None else ops.numel()
    err = zf_kernel.load().zf_filtered_reduce(
        3, 1, x.data_ptr(), 1, x.numel(), 0 if ops is None else ops.data_ptr(),
        0 if ops is None else imms.data_ptr(), n, partials.data_ptr(), tickets.data_ptr(),
        bpc, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"planted launch failed: cudaError {err}")
    return out


def zone_filter_identity(torch, tp, zf_kernel, zf_ops, failures):
    """Float sums of ``zone_filter.cu`` bit for bit, at the 256 KiB chunk
    and the 256 MiB zone, bare and through a program: a single launch, the
    same chunk as a row of a batched launch of two, repeated calls (each
    leaves its tickets at 0 for the next) and the chunk on two streams at
    once (held back behind a sleep on each stream, so that their launches
    overlap on the card); then rows of a batched launch at the array's
    dispatch shape, 512 chunks of 64 pages, where a CUDA block runs 4 fold
    blocks (bpc 32 one-tile fold blocks a chunk and 512 chunks:
    zone_filter.cu::launch groups them by 4), each against its chunk
    alone. Every wrapper call must be one launch. Then, after the counted
    calls, planted faults that the bit check must reject, each one launch
    through the C entry: a ticket left at the block count, as a launch
    without the reset would leave it (no block folds; the result stays
    NaN); and, at the zone, a ticket one short of the block count over the
    partials a launch on other data left, so that the first block to
    arrive folds while most partials are stale (its 1,024 blocks do not
    fit on the card at once, so the second wave has not started): a finite
    wrong sum. A fold in another order is no planted fault: it gives the
    same float bits too often (3 of 4 cases with half the blocks, on an
    H100)."""
    scaled = tp.Program("float32", (tp.Instruction(tp.OpCode.MUL, 2.0),
                                    tp.Instruction(tp.OpCode.CMP_GE, 10.0),
                                    tp.Instruction(tp.OpCode.RED_SUM)), name="scaled_sum")
    programs_ = {"bare": (None, None), "scaled_sum": zf_ops.encode_program(scaled, DEVICE)}
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    rows, planted, checks = {}, {}, 0

    def counts():
        return zf_kernel.filtered_reduce.launches, zf_kernel.filtered_reduce_batched.launches

    def held(key, runs, single, n0, calls, **extra):
        nonlocal checks
        n1 = counts()
        bad = [k for k, r in runs.items() if not same_bits(torch, r, single)]
        checks += len(runs) + 1
        if bad:
            failures.append(f"bit identity {key}: {bad} differ from the single launch")
        if (n1[0] - n0[0], n1[1] - n0[1]) != calls:
            failures.append(f"bit identity {key}: {n1[0] - n0[0]} single and "
                            f"{n1[1] - n0[1]} batched launches for {calls} calls")
        rows[key] = dict(runs=len(runs), differing=bad, **extra)

    def plant(key, x, single, ops, imms, bpc, ticket, partials, what):
        nonlocal checks
        got = raw_filtered_reduce(torch, zf_kernel, x, ops, imms, bpc, ticket, partials)
        caught = not same_bits(torch, got, single)
        finite = bool(torch.isfinite(got))
        planted[f"{what}:{key}"] = dict(value=float(got), finite=finite, caught=caught)
        checks += 1
        if not caught:
            failures.append(f"the bit-identity check passed {what} at {key}")
        return finite

    for n_pages in (ARRAY_STRIPE, ZONE_BYTES // PAGE_BYTES):
        x = card_pages(torch, "float32", n_pages, seed=500 + n_pages)
        batch = torch.stack([card_pages(torch, "float32", n_pages, seed=501), x])
        y = x.clone()
        bpc = zf_kernel.blocks_per_chunk(x.numel(), 4)
        for pname, (ops, imms) in programs_.items():
            def call(t, ops=ops, imms=imms):
                return zf_kernel.filtered_reduce(t, kind="sum", ops=ops, imms=imms)
            n0 = counts()
            single = call(x)
            runs = {"batched_row": zf_kernel.filtered_reduce_batched(
                batch, kind="sum", ops=ops, imms=imms)[1]}
            for r in range(3):
                runs[f"repeat_{r}"] = call(x)
            torch.cuda.synchronize()
            for s in (s1, s2):
                s.wait_stream(torch.cuda.current_stream())
            streamed = []
            for s in (s1, s2):
                with torch.cuda.stream(s):
                    torch.cuda._sleep(2_000_000)     # about 1 ms: both queues fill first
            for _ in range(4):
                for s, t in ((s1, x), (s2, y)):
                    with torch.cuda.stream(s):
                        streamed.append(call(t))
            torch.cuda.synchronize()
            runs.update({f"stream{i % 2 + 1}_{i // 2}": r for i, r in enumerate(streamed)})
            key = f"{pname}@{n_pages}"
            held(key, runs, single, n0, (1 + 3 + len(streamed), 1), value=float(single),
                 blocks_per_chunk=bpc)
            # the planted faults, after the counted calls
            partials = torch.empty(bpc, dtype=torch.int64, device=DEVICE)
            plant(key, x, single, ops, imms, bpc, bpc, partials, "a ticket left at bpc")
            if n_pages == ARRAY_STRIPE:
                continue
            raw_filtered_reduce(torch, zf_kernel, batch[0], ops, imms, bpc, 0, partials)
            if not plant(key, x, single, ops, imms, bpc, bpc - 1, partials,
                         "a ticket at bpc - 1"):
                failures.append(f"the early fold at {key} gave no finite sum")
        del x, y, batch
    # the array's dispatch shape: 4 fold blocks a CUDA block
    chunks, pages = BATCH_SHAPES[1]
    xb = card_pages(torch, "float32", chunks * pages, seed=502).reshape(chunks, pages, -1)
    picked = (0, 1, chunks // 2 + 1, chunks - 1)
    for pname, (ops, imms) in programs_.items():
        n0 = counts()
        got = zf_kernel.filtered_reduce_batched(xb, kind="sum", ops=ops, imms=imms)
        for i in picked:
            single = zf_kernel.filtered_reduce(xb[i], kind="sum", ops=ops, imms=imms)
            held(f"{pname}@batched_{chunks}x{pages}_row{i}", {"batched_row": got[i]}, single,
                 n0, (picked.index(i) + 1, 1), value=float(single))
    del xb
    torch.cuda.empty_cache()
    return dict(checks=checks, rows=rows, planted_faults=planted)


# ------------------------------------------------------------ paged_attn

def paged_tables(rng, B, NZ, ZL, MZ, edges, zps):
    """(zone_table [B, MZ] int32, lengths [B] int32) on the host: random
    distinct zones with a -1 tail and a length inside them, as
    tests/test_kernels.py::_paged_case draws them. With ``edges`` (B >=
    EDGE_ROWS) row 0 has length 0, row 1 an all -1 table, row 2 a -1 hole
    in a full row, row 3 all MZ*ZL positions and row 4 a length that is a
    multiple of ZL. Rows 5-7 sit at the kernel's splits of ``zps`` zones, in
    full rows: row 5 has its second split all -1, row 6 valid zones in its
    last split only, row 7 a length one token past the first split's end.
    In a one-split table rows 5 and 6 keep only their last zone and row 7
    one token of its last zone."""
    tab = np.full((B, MZ), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        nz = rng.integers(1, MZ + 1)
        tab[b, :nz] = rng.choice(NZ, size=nz, replace=False)
        lengths[b] = rng.integers(1, nz * ZL + 1)
    if edges:
        lengths[0] = 0
        tab[1], lengths[1] = -1, 2 * ZL
        tab[2] = rng.choice(NZ, size=MZ, replace=False)
        tab[2, MZ // 2] = -1
        lengths[2] = MZ * ZL
        tab[3] = rng.choice(NZ, size=MZ, replace=False)
        lengths[3] = MZ * ZL
        lengths[4] = (tab[4] >= 0).sum() * ZL
        for r in (5, 6, 7):
            tab[r] = rng.choice(NZ, size=MZ, replace=False)
            lengths[r] = MZ * ZL
        if zps < MZ:
            tab[5, zps:2 * zps] = -1
            tab[6, :(-(-MZ // zps) - 1) * zps] = -1
            lengths[7] = zps * ZL + 1
        else:
            tab[5:7, :MZ - 1] = -1
            lengths[7] = (MZ - 1) * ZL + 1
    return tab, lengths


def paged_inputs(torch, B, H, KV, hd, NZ, ZL, MZ, dtype, seed, edges, zps):
    """q, K, V drawn on the card from a seeded generator; the tables from a
    seeded numpy draw."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = getattr(torch, dtype)
    q = torch.randn(B, H, hd, generator=g, device=DEVICE, dtype=tdt)
    k = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=tdt)
    v = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=tdt)
    tab, lengths = paged_tables(np.random.default_rng(seed), B, NZ, ZL, MZ, edges, zps)
    return q, k, v, torch.from_numpy(tab).to(DEVICE), torch.from_numpy(lengths).to(DEVICE)


def paged_close(torch, got, want):
    """(ok, max_abs_err, share) of a paged_attention result against ref.py:
    ``share`` is the largest |got - want| over its limit in PAGED_TOL, so
    ok needs a share <= 1, the same dtype and shape, and finite values."""
    atol, rtol = PAGED_TOL[str(want.dtype).removeprefix("torch.")]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (atol + rtol * want.float().abs())).max())
    ok = (got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(got).all()) and share <= 1.0)
    return ok, float(diff.max()), share


def paged_attention_checks(torch, pa_kernel, pa_ref, failures):
    """The kernel against ref.py on the card: ({dtype: max_abs_err},
    {dtype: largest share of the limit}, checks). Every case runs at the
    split kernel.py::plan picks and at S = 1 (one split a row), and its
    plan's shared memory is held against the kernel's own (pa_smem_bytes).
    float32 references run with TF32 off, so their einsums are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = []                                      # (label, B, H, KV, hd, NZ, ZL, MZ, edges)
    for B, H, KV, hd, NZ, ZL, MZ in TEST_GEOMETRIES:
        cases.append((f"test {H}/{KV}/{hd}", B, H, KV, hd, NZ, ZL, MZ, False))
        cases.append((f"test {H}/{KV}/{hd} edges", EDGE_ROWS, H, KV, hd, NZ, ZL, MZ, True))
    for H, KV, hd in CONFIG_GEOMETRIES:
        cases.append((f"config {H}/{KV}/{hd}", EDGE_ROWS, H, KV, hd, 64, 16, 6, True))
    # 64 query heads on one KV head: more columns than a CTA's 8 consumer
    # warps, so each sequence's heads are cut over 2 CTAs
    cases.append(("wide group 64/1/64", EDGE_ROWS, 64, 1, 64, 64, 16, 6, True))
    B, H, KV, hd, NZ, ZL, MZ = SPLIT_GEOMETRY
    cases.append((f"splits {H}/{KV}/{hd}", B, H, KV, hd, NZ, ZL, MZ, False))
    cases.append((f"splits {H}/{KV}/{hd} edges", B, H, KV, hd, NZ, ZL, MZ, True))
    cases.append(("granite-8b pool", 64, GRANITE_HEADS, GRANITE["kv_heads"],
                  GRANITE["head_dim"], GRANITE["num_zones"], GRANITE["zone_len"],
                  GRANITE["max_zones_per_seq"], True))
    errs = {"float32": 0.0, "bfloat16": 0.0}
    shares = dict(errs)
    n = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = pa_kernel.load()
    for i, (label, B, H, KV, hd, NZ, ZL, MZ, edges) in enumerate(cases):
        for dtype in PAGED_TOL:
            itemsize = 4 if dtype == "float32" else 2
            plan = pa_kernel.plan(B, H, KV, hd, MZ, ZL, itemsize, sms)
            c_smem = lib.pa_smem_bytes(int(dtype == "bfloat16"), H, KV, hd, plan.kv_chunk,
                                       plan.head_groups, plan.stage_tokens, plan.stages)
            if c_smem != plan.smem:
                failures.append(f"paged_attention {label} {dtype}: plan's shared memory "
                                f"{plan.smem}, the kernel's {c_smem}")
            q, k, v, tab, lengths = paged_inputs(torch, B, H, KV, hd, NZ, ZL, MZ, dtype,
                                                 seed=500 + i, edges=edges,
                                                 zps=plan.zones_per_split)
            want = pa_ref.paged_attention_ref(q, k, v, tab, lengths)
            for zps in sorted({plan.zones_per_split, MZ}):
                got = pa_kernel.paged_attention_kernel(q, k, v, tab, lengths,
                                                       zones_per_split=zps)
                n += 1
                ok, err, share = paged_close(torch, got, want)
                errs[dtype] = max(errs[dtype], err)
                shares[dtype] = max(shares[dtype], share)
                if not ok:
                    failures.append(f"paged_attention {label} {dtype} S={-(-MZ // zps)}: "
                                    f"max_abs_err {err}, {share} of the limit")
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return errs, shares, n


def phase_offload(torch, tp, NvmCsd, ZonedDevice, csd_mod, zf_kernel, runs=5):
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    dev = ZonedDevice(num_zones=1, zone_bytes=ZONE_BYTES)
    data = rng.integers(0, RAND_MAX, dev.zone_bytes // 4, dtype=np.int32)
    dev.zone_append(0, data)
    expected = int((data > RAND_MAX // 2).sum())
    fill_s = time.perf_counter() - t0
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    csd = NvmCsd(dev, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()

    zf_kernel.filtered_reduce.launches = 0
    zf_kernel.filtered_reduce_batched.launches = 0
    copies0 = csd_mod.h2d.snapshot()[0]
    tiers = {}
    for tier in ("kernel", "jit"):
        per_run = []
        for r in range(runs + 1):
            t = time.perf_counter()
            value, stats = csd.run_and_fetch(program, 0, tier=tier)
            wall = time.perf_counter() - t
            check(int(value) == expected, f"{tier}: {int(value)} != numpy {expected}")
            check(stats.tier == tier, f"asked {tier}, ran {stats.tier}")
            per_run.append((wall, stats))
        cold, warm = per_run[0][1], per_run[1:]
        tiers[tier] = dict(
            value=int(value), offload_ms_median=statistics.median(w for w, _ in warm) * 1e3,
            exec_ms_median=statistics.median(s.exec_seconds for _, s in warm) * 1e3,
            h2d_ms_median=statistics.median(s.h2d_seconds for _, s in warm) * 1e3,
            jit_seconds=cold.jit_seconds, warm_jit_seconds=max(s.jit_seconds for _, s in warm),
            bytes_read=cold.bytes_read, bytes_returned=cold.bytes_returned,
            movement_saved_bytes=cold.movement_saved_bytes)
    launches = {"filtered_reduce": zf_kernel.filtered_reduce.launches,
                "filtered_reduce_batched": zf_kernel.filtered_reduce_batched.launches}
    copies = csd_mod.h2d.snapshot()[0] - copies0
    check(launches["filtered_reduce"] == runs + 1,
          f"kernel tier launched filtered_reduce {launches['filtered_reduce']} times")
    check(copies == 2 * (runs + 1), f"{copies} host-to-card copies for {2 * (runs + 1)} offloads")
    peak = torch.cuda.max_memory_allocated()

    small = ZonedDevice(num_zones=1, zone_bytes=INTERP_ZONE_BYTES)
    small_data = data[: small.zone_bytes // 4]
    small.zone_append(0, small_data)
    t = time.perf_counter()
    value, stats = NvmCsd(small, device=DEVICE).run_and_fetch(program, 0, tier="interp")
    interp_s = time.perf_counter() - t
    check(int(value) == int((small_data > RAND_MAX // 2).sum()), "interp tier count")
    tiers["interp_4MiB"] = dict(value=int(value), offload_ms=interp_s * 1e3,
                                bytes_returned=stats.bytes_returned,
                                movement_saved_bytes=stats.movement_saved_bytes)
    emit("offload", zone_bytes=dev.zone_bytes, fill_seconds=fill_s, expected=expected,
         tiers=tiers, launches=launches, h2d_copies=copies,
         max_memory_allocated=peak)
    csd_mod.unpin_zone_memory(dev)
    return data, launches, tiers["kernel"]["value"]


def build_array(ZonedDevice, StripedZoneArray, mode, n):
    """A ``mode`` array of ``n`` members, each zone the logical zone over
    the data members, rounded up to whole stripes."""
    data_members = {"raid0": n, "raid1": n // 2, "xor": n - 1}[mode]
    stripe_bytes = ARRAY_STRIPE * PAGE_BYTES
    stripes = -(-ZONE_BYTES // (stripe_bytes * data_members))
    members = [ZonedDevice(num_zones=1, zone_bytes=stripes * stripe_bytes)
               for _ in range(n)]
    return StripedZoneArray(members, stripe_blocks=ARRAY_STRIPE, redundancy=mode)


def array_plan(array_mod, array, n_blocks, prefetch_depth=2):
    """What the scheduler must do for one offload of ``n_blocks``, from
    the reference's arithmetic (``src/repro/array/scheduler.py:951-1000``):
    full chunks read directly go in groups of ``m_b`` (a power of two, at
    least 2), one batched dispatch a group, each member's contiguous run in
    a group one copy to the card; every other chunk runs alone, one copy
    and one single launch each."""
    chunks = array.chunks(0, 0, n_blocks)
    full = [c for c in chunks if not c.reconstruct and c.n_blocks == ARRAY_STRIPE]
    if len(full) < 2:
        full = []
    alone = len(chunks) - len(full)
    groups = []
    if full:
        n_groups = min(prefetch_depth, len(full))
        m_b = max(1 << (-(-len(full) // n_groups) - 1).bit_length(), 2)
        groups = [full[i:i + m_b] for i in range(0, len(full), m_b)]
    runs = sum(len(array_mod.striping.coalesce_member_runs(g, ARRAY_STRIPE)) for g in groups)
    return dict(n_chunks=len(chunks), batched_chunks=len(full), n_dispatches=len(groups),
                degraded_reads=sum(c.degraded for c in chunks), singles=alone,
                copies=runs + alone, bytes=n_blocks * PAGE_BYTES)


def phase_array(torch, tp, ZonedDevice, array_mod, csd_mod, trace, zf_kernel, data,
                csd_count, runs=5):
    """The Figure 2 zone striped over each layout of ARRAY_RUNS and offloaded
    through ``OffloadScheduler(device="cuda")`` on the kernel tier, with the
    scheduler's defaults (pages_per_read=1, prefetch_depth=2). Per layout:
    one cold and ``runs`` warm offloads of the whole zone, then one traced
    with the repo's span tracer (``trace_ms``: each span's summed ms in that
    offload, by name), each count equal to numpy's and NvmCsd's, each
    offload's stats, launches and host-to-card copies equal to
    :func:`array_plan`; at width 4 one more offload of a partial extent
    whose last chunk is a tail. Reports the median warm offload (host clock
    around ``run_and_fetch``) and the medians of the stages in
    ``ArrayOffloadStats``."""
    t_phase = time.perf_counter()
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    n_blocks = ZONE_BYTES // PAGE_BYTES
    expected = int((data > RAND_MAX // 2).sum())
    check(expected == csd_count, f"NvmCsd counted {csd_count}, numpy {expected}")
    tail_blocks = n_blocks - ARRAY_TAIL_BLOCKS
    tail_expected = int((data[:tail_blocks * PAGE_BYTES // 4] > RAND_MAX // 2).sum())
    zf_kernel.filtered_reduce.launches = 0
    zf_kernel.filtered_reduce_batched.launches = 0
    launches = {"filtered_reduce": 0, "filtered_reduce_batched": 0}
    rows = []
    for mode, n, dead in ARRAY_RUNS:
        t0 = time.perf_counter()
        array = build_array(ZonedDevice, array_mod.StripedZoneArray, mode, n)
        array.zone_append(0, data)
        if dead is not None:
            array.set_offline(0, device=dead)
        fill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sched = array_mod.OffloadScheduler(array, default_tier="kernel", device=DEVICE)
        pin_s = time.perf_counter() - t0
        extents = [n_blocks] * (runs + 2) + ([tail_blocks] if n == 4 and dead is None else [])
        label = f"{mode}x{n}" + (f" member {dead} offline" if dead is not None else "")
        per_run = []
        for k, extent in enumerate(extents):
            plan = array_plan(array_mod, array, extent)
            before = (zf_kernel.filtered_reduce.launches,
                      zf_kernel.filtered_reduce_batched.launches, *csd_mod.h2d.snapshot())
            traced = k == runs + 1
            m0 = time.monotonic()           # the tracer's clock
            t = time.perf_counter()
            with trace.tracing(traced):
                value, st = sched.run_and_fetch(program, 0, n_blocks=extent)
            wall = time.perf_counter() - t
            after = (zf_kernel.filtered_reduce.launches,
                     zf_kernel.filtered_reduce_batched.launches, *csd_mod.h2d.snapshot())
            single, batched, copies, nbytes = (a - b for a, b in zip(after, before))
            want = expected if extent == n_blocks else tail_expected
            check(int(value) == want, f"{label}: counted {int(value)}, numpy {want}")
            got = dict(n_chunks=st.n_chunks, batched_chunks=st.batched_chunks,
                       n_dispatches=st.n_dispatches, degraded_reads=st.degraded_reads,
                       singles=single, copies=copies, bytes=nbytes)
            check(got == plan, f"{label} extent {extent}: {got} != plan {plan}")
            check(batched == st.n_dispatches, f"{label}: {batched} batched launches for "
                                              f"{st.n_dispatches} dispatches")
            check(st.tier == "kernel", f"{label}: ran on {st.tier}")
            if mode == "raid0" and extent == n_blocks:
                check(copies == 2 * n, f"{label}: {copies} copies, 2 groups x {n} members")
            if dead is not None:
                check(st.degraded_reads > 0, f"{label}: no degraded read")
            launches["filtered_reduce"] += single
            launches["filtered_reduce_batched"] += batched
            if 0 < k <= runs:
                per_run.append((wall, st))
            if traced:
                spans = {}
                for ev in trace.drain():
                    if ev["type"] == "span" and ev["ts"] >= m0:
                        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] * 1e3
                traced_run = dict(offload_ms=wall * 1e3, trace_ms=spans)
            last = dict(got, value=int(value), extent_blocks=extent)

        def med(f):
            return statistics.median(f(w, st) for w, st in per_run) * 1e3
        rows.append(dict(
            layout=label, members=n, member_zone_bytes=array.devices[0].zone_bytes,
            fill_seconds=fill_s, pin_seconds=pin_s,
            offload_ms_median=med(lambda w, st: w),
            offload_ms_runs=[w * 1e3 for w, _ in per_run],
            h2d_ms_median=med(lambda w, st: st.h2d_seconds),
            stage_ms_median=med(lambda w, st: st.stage_seconds),
            compute_ms_median=med(lambda w, st: st.compute_seconds),
            combine_ms_median=med(lambda w, st: st.combine_seconds),
            read_wait_ms_median=med(lambda w, st: st.read_wait_seconds),
            exec_ms_median=med(lambda w, st: st.exec_seconds),
            traced_offload=traced_run, last_offload=last))
        sched.close()
        for member in array.devices:
            csd_mod.unpin_zone_memory(member)
        del sched, array
        gc.collect()
    check(launches == {"filtered_reduce": zf_kernel.filtered_reduce.launches,
                       "filtered_reduce_batched": zf_kernel.filtered_reduce_batched.launches},
          "kernels launched outside the counted offloads")
    emit("array", expected=expected, nvmcsd=csd_count, stripe_blocks=ARRAY_STRIPE,
         chunk_bytes=ARRAY_STRIPE * PAGE_BYTES, runs=rows, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


def phase_batched(torch, tp, zf_kernel, zf_ops, data):
    """The chunk-batched entry over the zone as 8 chunks (the array's shape)."""
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    chunks = data.reshape(8, -1, 1024)
    zf_kernel.filtered_reduce.launches = 0
    zf_kernel.filtered_reduce_batched.launches = 0
    rows = zf_ops.run_program_kernel_batched(program, chunks, device=DEVICE)
    launches = zf_kernel.filtered_reduce_batched.launches
    want = (chunks > RAND_MAX // 2).sum(axis=(1, 2))
    check(np.array_equal(rows.astype(np.int64), want), f"batched rows {rows} vs {want}")
    check(launches == 1, f"batched entry launched the kernel {launches} times")
    emit("batched", chunks=int(chunks.shape[0]), rows=rows.tolist(), launches=launches)
    return launches


# ---------------------------------------------------------------- serving

SERVE_WAVE1 = (32, 2048)        # sequences, history tokens each
SERVE_WAVE2 = (16, 1024)
SERVE_STEPS = 8                 # decode steps of each wave
SERVE_EVICT = 16                # wave-1 sequences evicted before wave 2
RESIDENT_TOKENS = 4096          # tokens of each resident sequence


def phase_serve(torch, KVZonePool, pa_kernel, pa_ref):
    """Zoned-KV decode at granite-8b width through the port's entry points.

    Wave 1: 32 sequences append a 2,048-token history, then decode 8 steps
    (one append per sequence, then one attend over all of them). Resident
    sequences at a 4K context then take every free zone (``extend``, one
    copy a zone), so the pool is full. 16 wave-1 sequences are evicted (zone
    resets); wave 2's 16 new sequences append 1,024 tokens each into the
    reclaimed zones, and all 32 decode 8 steps on ragged lengths. Every
    attend is held against ref.py after it is timed; after the counted
    window, two planted faults on each wave's last step must fail the same
    check. Per step: ``appends_ms`` (host clock, 32 appends and a
    synchronize), ``attend_ms`` (host clock around attend and a synchronize:
    zone table, its two copies, the kernel), ``zone_table_ms`` (a second
    zone_table call, timed alone) and ``kernel_ms`` (CUDA events around the
    kernel relaunched on the step's tables after the counted window)."""
    nz, zl = GRANITE["num_zones"], GRANITE["zone_len"]
    kvh, hd = GRANITE["kv_heads"], GRANITE["head_dim"]
    g = torch.Generator(device=DEVICE).manual_seed(13)
    tdt = torch.bfloat16

    def tokens(n):
        return (torch.randn(n, kvh, hd, generator=g, device=DEVICE, dtype=tdt),
                torch.randn(n, kvh, hd, generator=g, device=DEVICE, dtype=tdt))

    def fill(pool, sid, n):
        k, v = tokens(n)
        for t in range(n):
            pool.append(sid, k[t], v[t])

    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    pool = KVZonePool(**GRANITE, dtype=tdt, device=DEVICE)
    pa_kernel.paged_attention_kernel.launches = 0
    steps, saved, errs, shares, attends = [], [], [], [], 0

    def decode(seqs, wave):
        nonlocal attends
        for _ in range(SERVE_STEPS):
            k, v = tokens(len(seqs))
            q = torch.randn(len(seqs), GRANITE_HEADS, hd, generator=g, device=DEVICE, dtype=tdt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, sid in enumerate(seqs):
                pool.append(sid, k[i], v[i])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = pool.attend(seqs, q)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            attends += 1
            tab, lengths = pool.zone_table(seqs)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ok, err, share = paged_close(
                torch, out, pa_ref.paged_attention_ref(q, pool.k, pool.v, tab, lengths))
            errs.append(err)
            shares.append(share)
            check(ok, f"serve wave {wave}: attend differs from ref.py by {err}, "
                      f"{share} of the limit")
            saved.append((q, tab, lengths))
            steps.append(dict(wave=wave, appends_ms=(t1 - t0) * 1e3,
                              attend_ms=(t2 - t1) * 1e3, zone_table_ms=(t3 - t2) * 1e3,
                              tokens=int(lengths.sum())))

    wave1 = list(range(SERVE_WAVE1[0]))
    t = time.perf_counter()
    for sid in wave1:
        pool.add_sequence(sid)
        fill(pool, sid, SERVE_WAVE1[1])
    torch.cuda.synchronize()
    history1_s = time.perf_counter() - t
    decode(wave1, 1)
    used1 = round(pool.utilization() * nz)
    zones1 = -(-(SERVE_WAVE1[1] + SERVE_STEPS) // zl)
    check(used1 == SERVE_WAVE1[0] * zones1, f"wave 1 holds {used1} zones")

    # resident sequences at a 4K context take every free zone
    t = time.perf_counter()
    free, per = nz - used1, -(-RESIDENT_TOKENS // zl)
    residents = -(-free // per)
    for j in range(residents):
        pool.add_sequence(10_000 + j)
        pool.extend(10_000 + j, *tokens(min(per, free - j * per) * zl))
    torch.cuda.synchronize()
    residents_s = time.perf_counter() - t
    check(pool.utilization() == 1.0, f"pool not full: {pool.utilization()}")

    evicted = wave1[:SERVE_EVICT]
    ev_tab, _ = pool.zone_table(evicted)
    reclaimed = [int(z) for z in ev_tab.flatten().tolist() if z >= 0]
    reset0 = pool.stats["zones_reset"]
    for sid in evicted:
        pool.evict(sid)
    check(pool.stats["zones_reset"] - reset0 == SERVE_EVICT * zones1 == len(reclaimed),
          f"evicting {SERVE_EVICT} sequences reset {pool.stats['zones_reset'] - reset0} zones")
    util_evicted = pool.utilization()
    check(util_evicted == (nz - len(reclaimed)) / nz, f"utilization {util_evicted} after evict")
    alloc0 = pool.stats["zones_allocated"]

    wave2 = [100 + i for i in range(SERVE_WAVE2[0])]
    t = time.perf_counter()
    for sid in wave2:
        pool.add_sequence(sid)
        fill(pool, sid, SERVE_WAVE2[1])
    torch.cuda.synchronize()
    history2_s = time.perf_counter() - t
    both = wave1[SERVE_EVICT:] + wave2
    decode(both, 2)
    w2_tab, _ = pool.zone_table(wave2)
    w2_zones = [int(z) for z in w2_tab.flatten().tolist() if z >= 0]
    zones2 = -(-(SERVE_WAVE2[1] + SERVE_STEPS) // zl)
    new_alloc = pool.stats["zones_allocated"] - alloc0
    # the free list was the reset zones alone, in reset order (FIFO)
    check(set(w2_zones) <= set(reclaimed[:new_alloc])
          and len(w2_zones) == SERVE_WAVE2[0] * zones2,
          "wave-2 zones are not the reclaimed ones, in reset order")
    util_end = pool.utilization()
    check(util_end == (nz - len(reclaimed) + new_alloc) / nz, f"final utilization {util_end}")
    launches = pa_kernel.paged_attention_kernel.launches
    check(launches == attends, f"{attends} attends launched the kernel {launches} times")
    peak = torch.cuda.max_memory_allocated()

    # planted faults, after the counted window: the kernel given a length one
    # short, or a table without each row's last zone, must fail the check
    def drop_last_zone(tab, lengths):
        tab = tab.clone()
        last = ((lengths.long() - 1) // zl).clamp(min=0)
        tab[torch.arange(len(tab), device=tab.device), last] = -1
        return tab, lengths
    faults = {"length_one_short": lambda tab, lengths: (tab, (lengths - 1).clamp(min=0)),
              "last_zone_dropped": drop_last_zone}
    planted = {name: [] for name in faults}
    for q, tab, lengths in (saved[SERVE_STEPS - 1], saved[-1]):
        want = pa_ref.paged_attention_ref(q, pool.k, pool.v, tab, lengths)
        for name, fault in faults.items():
            got = pa_kernel.paged_attention_kernel(q, pool.k, pool.v, *fault(tab, lengths))
            ok, err, share = paged_close(torch, got, want)
            planted[name].append(dict(max_abs_err=err, share_of_limit=share))
            check(not ok, f"the serve check passed a planted fault: {name}")

    # the kernel alone on each step's tables, after the counted window
    for st, args in zip(steps, saved):
        st["kernel_ms"] = cuda_ms(
            torch, lambda a=args: pa_kernel.paged_attention_kernel(a[0], pool.k, pool.v, *a[1:]),
            reps=5, warmup=1)

    def med(key, wave=None):
        return statistics.median(st[key] for st in steps if wave in (None, st["wave"]))
    per_step = {k: med(k) for k in ("appends_ms", "zone_table_ms", "attend_ms", "kernel_ms")}
    per_step["step_ms"] = statistics.median(st["appends_ms"] + st["attend_ms"] for st in steps)
    by_wave = {w: {k: med(k, w) for k in ("appends_ms", "attend_ms", "kernel_ms", "tokens")}
               for w in (1, 2)}
    history_tokens = SERVE_WAVE1[0] * SERVE_WAVE1[1] + SERVE_WAVE2[0] * SERVE_WAVE2[1]
    emit("serve", pool=dict(GRANITE, dtype="bfloat16", heads=GRANITE_HEADS,
                            bytes=2 * pool.k.numel() * pool.k.element_size()),
         attends=attends, launches=launches,
         zones_reset=pool.stats["zones_reset"], zones_allocated=pool.stats["zones_allocated"],
         tokens_appended=pool.stats["tokens_appended"], residents=residents,
         reclaimed_zones_reused=new_alloc, utilization_after_evict=util_evicted,
         utilization_end=util_end, max_abs_err=max(errs), share_of_limit=max(shares),
         planted_faults=planted, median_per_step=per_step,
         median_by_wave=by_wave, history_seconds=[history1_s, history2_s],
         append_us=(history1_s + history2_s) * 1e6 / history_tokens,
         residents_seconds=residents_s, resident_zones=free,
         seconds=time.perf_counter() - t_build, max_memory_allocated=peak)
    del pool, saved
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------- training data and state

def phase_pipeline(torch, ZonedDevice, array_mod, csd_mod, data_mod, zf_kernel, trace, card):
    """The training-data pushdown on the card's jit tier.

    Each zone of the corpus goes through ``ZoneDataPipeline._zone_records``
    (a FIELD/CMP_GE/RED_COUNT offload, then SELECT_REC at exactly that
    capacity); its count and its records (quality, tokens, zero padding)
    must equal numpy's filter of the appended arrays, in stream order. Then
    ``batches`` over every zone, whose first PIPE_BATCHES_CHECKED batches
    must equal numpy's permutation of the kept records under the same seed,
    the histograms (RED_HIST over each whole zone) numpy's, and
    ``PipelineStats`` the sum of each offload's bytes. The same bytes on a
    raid0 array through ``OffloadScheduler`` must give the same records.
    Times: host clock around each zone's two offloads, and each offload's
    ``exec``/``h2d`` (and on the array its stages) from the CSD's history;
    the last zone of each runs under the span tracer (``trace_ms``: each
    span's summed ms in its two offloads, by name)."""
    def traced_zone(pipe, z):
        m0 = time.monotonic()
        t = time.perf_counter()
        with trace.tracing(z == PIPE_ZONES - 1):
            recs = pipe._zone_records(z)
        wall = time.perf_counter() - t
        spans = {}
        for ev in trace.drain() if z == PIPE_ZONES - 1 else ():
            if ev["type"] == "span" and ev["ts"] >= m0:
                spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] * 1e3
        return recs, wall, spans

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    dev = ZonedDevice(num_zones=PIPE_ZONES, zone_bytes=ZONE_BYTES)
    store = data_mod.ZoneDataStore(dev, PIPE_SEQ)
    stride = store.stride
    per_zone = dev.zone_bytes // (stride * 4)
    corpus = []
    for z in range(PIPE_ZONES):
        tokens = rng.integers(0, PIPE_VOCAB, (per_zone, PIPE_SEQ), dtype=np.int32)
        quality = rng.integers(0, 100, per_zone, dtype=np.int32)
        store.append_records(z, tokens, quality)
        corpus.append((tokens, quality))
    fill_s = time.perf_counter() - t_phase
    n_blocks = [dev.zone(z).write_pointer for z in range(PIPE_ZONES)]
    check(all(store.records_in_zone(z) == per_zone for z in range(PIPE_ZONES)),
          "records in a zone")

    def expected(z):
        tokens, quality = corpus[z]
        keep = quality >= PIPE_MIN_QUALITY
        recs = np.zeros((int(keep.sum()), stride), np.int32)
        recs[:, 0] = quality[keep]
        recs[:, 1:1 + PIPE_SEQ] = tokens[keep]
        return recs

    zf_kernel.filtered_reduce.launches = 0
    zf_kernel.filtered_reduce_batched.launches = 0
    copies0 = csd_mod.h2d.snapshot()
    torch.cuda.reset_peak_memory_stats()
    pipe = data_mod.ZoneDataPipeline(store, batch=PIPE_BATCH, min_quality=PIPE_MIN_QUALITY,
                                     device=DEVICE)
    zones, kept, want_stats = [], [], dict(bytes_read_device=0, bytes_to_host=0,
                                           records_seen=0, records_kept=0, offloads=0)

    def account(z, n_kept):
        want_stats["bytes_read_device"] += 2 * n_blocks[z] * PAGE_BYTES
        want_stats["bytes_to_host"] += n_kept * stride * 4 + 8
        want_stats["records_seen"] += per_zone
        want_stats["records_kept"] += n_kept
        want_stats["offloads"] += 2

    for z in range(PIPE_ZONES):
        recs, wall, spans = traced_zone(pipe, z)
        want = expected(z)
        check(recs.shape == want.shape, f"zone {z}: kept {recs.shape[0]}, numpy {want.shape[0]}")
        check(np.array_equal(recs, want), f"zone {z}: selected records differ from numpy's")
        count_st, select_st = pipe.csd.history[-2:]
        check(count_st.tier == select_st.tier == "jit", f"zone {z}: ran on {select_st.tier}")
        account(z, want.shape[0])
        kept.append(want.shape[0])
        zones.append(dict(zone_ms=wall * 1e3, kept=want.shape[0],
                          count_exec_ms=count_st.exec_seconds * 1e3,
                          count_h2d_ms=count_st.h2d_seconds * 1e3,
                          select_exec_ms=select_st.exec_seconds * 1e3,
                          select_h2d_ms=select_st.h2d_seconds * 1e3,
                          select_bytes_returned=select_st.bytes_returned,
                          trace_ms=spans))
    peak_single = torch.cuda.max_memory_allocated()

    # a select's result copy alone, median of 3: into new pageable memory,
    # as the jit tier's to_host takes it, and into a page-locked buffer
    def copy_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)
    result = torch.zeros((kept[0], stride), dtype=torch.int32, device=DEVICE)
    pinned = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
    copy_back = dict(bytes=result.numel() * 4, pageable_ms=copy_ms(lambda: result.cpu()),
                     page_locked_ms=copy_ms(lambda: pinned.copy_(result)))
    del result, pinned

    # one epoch's first batches against numpy's permutation of the kept records
    t = time.perf_counter()
    batches = pipe.batches(list(range(PIPE_ZONES)), epochs=1, seed=SEED)
    got = [next(batches) for _ in range(PIPE_BATCHES_CHECKED)]
    first_batches_s = time.perf_counter() - t
    batches.close()
    for z in range(PIPE_ZONES):
        account(z, kept[z])
    pool = np.concatenate([expected(z)[:, 1:1 + PIPE_SEQ] for z in range(PIPE_ZONES)])
    order = np.random.default_rng(SEED).permutation(pool.shape[0])
    for i, b in enumerate(got):
        rows = pool[order[i * PIPE_BATCH:(i + 1) * PIPE_BATCH]]
        check(b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu",
              f"batch {i}: {b['tokens'].dtype} on {b['tokens'].device}")
        check(np.array_equal(b["tokens"].numpy(), rows[:, :-1])
              and np.array_equal(b["labels"].numpy(), rows[:, 1:]),
              f"batch {i} differs from numpy's recomputation")
    del pool

    hist_ms = []
    for z in range(PIPE_ZONES):
        t = time.perf_counter()
        hist = pipe.histogram(z, bins=64)
        hist_ms.append((time.perf_counter() - t) * 1e3)
        # the reference's bin of each distinct value (all are small and
        # non-negative here), weighted by how often it occurs in the zone
        tokens, quality = corpus[z]
        lo, hi, bins = 0, 2**31 - 1, 64
        counts = np.bincount(np.concatenate([tokens.reshape(-1), quality]))
        counts[0] += per_zone * (stride - 1 - PIPE_SEQ)        # the zero padding
        vals = np.arange(counts.size, dtype=np.float64)
        idx = np.clip(np.floor((vals - lo) * bins / (hi - lo)), 0, bins - 1).astype(np.int64)
        inside = (vals >= lo) & (vals < hi)
        want = np.bincount(idx[inside], weights=counts[inside], minlength=bins).astype(np.int64)
        check(np.array_equal(hist, want), f"zone {z}: histogram differs from numpy's")
    stats = {k: getattr(pipe.stats, k) for k in want_stats}
    check(stats == want_stats, f"PipelineStats {stats} != arithmetic {want_stats}")
    check(pipe.stats.movement_saved == want_stats["bytes_read_device"]
          - want_stats["bytes_to_host"], "movement_saved")
    copies = tuple(a - b for a, b in zip(csd_mod.h2d.snapshot(), copies0))
    check(copies[0] == 2 * 2 * PIPE_ZONES + PIPE_ZONES,
          f"{copies[0]} host-to-card copies for {5 * PIPE_ZONES} offloads")

    # the same bytes striped: raid0 x PIPE_MEMBERS through OffloadScheduler
    t = time.perf_counter()
    stripes = -(-ZONE_BYTES // (PIPE_STRIPE * PAGE_BYTES * PIPE_MEMBERS))
    members = [ZonedDevice(num_zones=PIPE_ZONES, zone_bytes=stripes * PIPE_STRIPE * PAGE_BYTES)
               for _ in range(PIPE_MEMBERS)]
    array = array_mod.StripedZoneArray(members, stripe_blocks=PIPE_STRIPE)
    for z in range(PIPE_ZONES):
        array.zone_append(z, dev.read_blocks_view(z, 0, n_blocks[z]))
    array_fill_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    striped = data_mod.ZoneDataPipeline(data_mod.ZoneDataStore(array, PIPE_SEQ),
                                        batch=PIPE_BATCH, min_quality=PIPE_MIN_QUALITY,
                                        device=DEVICE)
    check(isinstance(striped.csd, array_mod.OffloadScheduler), "striped pushdown scheduler")
    striped_zones = []
    for z in range(PIPE_ZONES):
        recs, wall, spans = traced_zone(striped, z)
        check(np.array_equal(recs, expected(z)), f"striped zone {z}: records differ")
        count_st, select_st = striped.csd.history[-2:]
        check(select_st.tier == "jit", f"striped zone {z}: ran on {select_st.tier}")
        striped_zones.append(dict(
            zone_ms=wall * 1e3, n_chunks=select_st.n_chunks,
            batched_chunks=select_st.batched_chunks, n_dispatches=select_st.n_dispatches,
            count_exec_ms=count_st.exec_seconds * 1e3, count_h2d_ms=count_st.h2d_seconds * 1e3,
            select_exec_ms=select_st.exec_seconds * 1e3,
            select_h2d_ms=select_st.h2d_seconds * 1e3,
            select_stage_ms=select_st.stage_seconds * 1e3,
            select_compute_ms=select_st.compute_seconds * 1e3,
            select_combine_ms=select_st.combine_seconds * 1e3,
            select_read_wait_ms=select_st.read_wait_seconds * 1e3, trace_ms=spans))
    peak_striped = torch.cuda.max_memory_allocated()
    striped.csd.close()
    launches = (zf_kernel.filtered_reduce.launches, zf_kernel.filtered_reduce_batched.launches)
    check(launches == (0, 0), f"zone_filter kernels launched {launches} times on the jit tier")
    for member in (dev, *members):
        csd_mod.unpin_zone_memory(member)

    def med(rows, key):
        return statistics.median(r[key] for r in rows)
    seen_bytes = sum(n_blocks) * PAGE_BYTES
    zone_s = sum(r["zone_ms"] for r in zones) / 1e3
    st = pipe.stats
    emit("pipeline", card=card, zones=PIPE_ZONES, zone_bytes=ZONE_BYTES, seq_len=PIPE_SEQ, stride=stride,
         records_per_zone=per_zone, tokens=PIPE_ZONES * per_zone * PIPE_SEQ, kept=kept,
         fill_seconds=fill_s, per_zone=zones,
         median_ms={k: med(zones, k) for k in ("zone_ms", "count_exec_ms", "count_h2d_ms",
                                                 "select_exec_ms", "select_h2d_ms")},
         records_per_s=PIPE_ZONES * per_zone / zone_s, read_gb_per_s=2 * seen_bytes / zone_s / 1e9,
         survivors_bytes_to_host=sum(kept) * stride * 4, select_copy_back=copy_back,
         first_batches_seconds=first_batches_s, histogram_ms=hist_ms,
         stats=dict(stats, movement_saved=st.movement_saved), h2d_copies=copies[0],
         h2d_bytes=copies[1], max_memory_allocated=peak_single,
         striped=dict(members=PIPE_MEMBERS, stripe_blocks=PIPE_STRIPE, fill_seconds=array_fill_s,
                      per_zone=striped_zones,
                      median_ms={k: med(striped_zones, k) for k in (
                          "zone_ms", "count_exec_ms", "count_h2d_ms", "select_exec_ms",
                          "select_h2d_ms")},
                      max_memory_allocated=peak_striped),
         kernel_launches=list(launches), seconds=time.perf_counter() - t_phase)
    del corpus, dev, members, array, pipe, striped
    gc.collect()
    torch.cuda.empty_cache()


def granite_layer_state(torch, g):
    """One granite-8b layer's train state on the card, shaped as the
    reference's ``train_state_specs`` (src/repro/models): bf16 params, f32
    AdamW moments of the same tree, an int32 step."""
    d, H, KV, hd, f = CKPT_DIMS
    shapes = {"attn": {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
                       "wo": (H, hd, d)},
              "ln1": {"scale": (d,)}, "ln2": {"scale": (d,)},
              "mlp": {"gate": (d, f), "up": (d, f), "down": (f, d)}}

    def tree(make):
        return {k: {n: make(shape) for n, shape in v.items()} for k, v in shapes.items()}
    return {
        "params": tree(lambda s: (torch.randn(s, generator=g, device=DEVICE) * 0.02)
                       .to(torch.bfloat16)),
        "m": tree(lambda s: torch.randn(s, generator=g, device=DEVICE) * 1e-3),
        "v": tree(lambda s: torch.rand(s, generator=g, device=DEVICE) * 1e-6),
        "step": torch.tensor(1, dtype=torch.int32, device=DEVICE),
    }


def phase_checkpoint(torch, ZonedDevice, train_mod, tree_mod, crash_mod, card):
    """Training state on zones, restored onto the card.

    Save step 1, perturb the moments (new tensors) and save step 2 (``save``
    runs ``gc``), restore the newest onto the card and hold every leaf to
    ``torch.equal`` on the card; a second store over the same device must
    recover step 2 cold. After the counted window, one byte of a step-2
    payload zone is flipped: that restore must raise CheckpointError and
    step 1 must still restore. Then the reference's raid1 power-loss sweep
    over card tensors. Times: host clock around each save and restore, split
    by the store's phase histograms."""
    t_phase = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    state1 = granite_layer_state(torch, g)
    state2 = dict(state1, step=state1["step"] + 1,
                  m={k: {n: t + torch.randn(t.shape, generator=g, device=DEVICE) * 1e-4
                         for n, t in v.items()} for k, v in state1["m"].items()},
                  v={k: {n: t * 0.999 for n, t in v.items()} for k, v in state1["v"].items()})
    torch.cuda.synchronize()
    leaves1 = tree_mod.leaves(state1)
    payload = sum(t.numel() * t.element_size() for t in leaves1)
    n_params = sum(t.numel() for t in tree_mod.leaves(state1["params"]))
    dev = ZonedDevice(num_zones=CKPT_ZONES, zone_bytes=CKPT_ZONE_BYTES)
    store = train_mod.ZonedCheckpointStore(device=dev, keep=2, torch_device=DEVICE)
    phases = ("save", "to_host", "save_crc", "restore", "restore_crc", "materialize",
              "to_device")

    def timed(fn):
        before = store.metrics.snapshot()
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        after = store.metrics.snapshot()
        split = {p: after.get(f"{p}_seconds.sum", 0.0) - before.get(f"{p}_seconds.sum", 0.0)
                 for p in phases}
        if split["save"]:       # the appends: the save ticket's life after the CRC
            split["appends"] = split["save"] - split["to_host"] - split["save_crc"]
        return out, dict(seconds=wall, gb_per_s=payload / wall / 1e9, **{
            f"{p}_seconds": v for p, v in split.items() if v})

    def same_on_card(got, want, label):
        g_leaves, w_leaves = tree_mod.leaves(got), tree_mod.leaves(want)
        check(str(tree_mod.flatten(got)[1]) == str(tree_mod.flatten(want)[1]),
              f"{label}: tree structure")
        for i, (a, b) in enumerate(zip(g_leaves, w_leaves)):
            check(a.device.type == "cuda", f"{label}: leaf {i} on {a.device}")
            check(a.dtype == b.dtype and torch.equal(a, b), f"{label}: leaf {i} differs")

    _, save1 = timed(lambda: store.save(1, state1))
    d2h = store.d2h.snapshot()
    check(d2h == (len(leaves1), payload), f"save 1 copied {d2h} off the card")
    manifest2, save2 = timed(lambda: store.save(2, state2))
    save2["gc_resets"] = dev.stats["zone_resets"]
    zones_used = sum(1 for z in dev.zones[1:] if z.write_pointer)
    got, restore2 = timed(lambda: store.restore(like=state1))
    same_on_card(got, state2, "restore of step 2")
    check(store.h2d.snapshot() == (len(leaves1), payload), "restore's host-to-card copies")
    del got
    reopened = train_mod.ZonedCheckpointStore(device=dev, keep=2, torch_device=DEVICE)
    check(reopened.steps() == [1, 2], f"reopen recovered steps {reopened.steps()}")
    store = reopened
    got, reopen_restore = timed(lambda: store.restore(like=state1))
    same_on_card(got, state2, "restore after reopen")
    del got

    # the planted fault, after the counted window: a flipped payload byte
    entry = next(e for e in manifest2["entries"] if e["bytes"] > PAGE_BYTES)
    dev._buf[entry["zone"] * dev.zone_bytes + entry["block"] * PAGE_BYTES + 100] ^= 0xFF
    try:
        store.restore(step=2, like=state1)
        refused = False
    except train_mod.CheckpointError:
        refused = True
    check(refused, "a flipped payload byte restored without CheckpointError")
    got, restore1 = timed(lambda: store.restore(step=1, like=state1))
    same_on_card(got, state1, "restore of step 1 after the fault")
    del got, store, reopened
    dev_bytes = dev.zone_bytes * dev.num_zones
    del dev
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        h = crash_mod.PowerLossHarness(tmp, torch_device=DEVICE, **SWEEP)
        steps = [(s, {"w": torch.arange(300, dtype=torch.float32, device=DEVICE) + s,
                      "b": torch.full((17,), s, dtype=torch.int32, device=DEVICE)})
                 for s in (1, 2)]
        outcomes = h.run(steps)
    sweep = dict(h.summary(), seconds=time.perf_counter() - t)
    check(sweep["all_ok"] and all(o.ok for o in outcomes), "power-loss sweep")
    check(outcomes[-1].recovered_step == 2 and outcomes[0].refused,
          "sweep ends: refusal at boundary 0, step 2 at the last")
    emit("checkpoint", card=card, leaves=len(leaves1), parameters=n_params, payload_bytes=payload,
         zones=CKPT_ZONES, zone_bytes=CKPT_ZONE_BYTES, zoned_bytes=dev_bytes,
         payload_zones_used=zones_used, save_step1=save1, save_step2=save2,
         restore_step2=restore2, restore_after_reopen=reopen_restore,
         restore_step1_after_fault=restore1, planted_fault_refused=refused,
         power_loss_sweep=sweep, seconds=time.perf_counter() - t_phase)
    del state1, state2, leaves1
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ model serving

def timed_serve(torch, ServeModel):
    """``ServeModel`` with CUDA events (device time) and the host clock
    (enqueue time) around each prefill and decode step of ``generate``."""
    class TimedServe(ServeModel):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.events = {"prefill": [], "decode": []}

        def _timed(self, kind, fn, *args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = fn(*args)
            end.record()
            self.events[kind].append((start, end, (time.perf_counter() - t) * 1e3))
            return out

        def prefill(self, batch):
            return self._timed("prefill", super().prefill, batch)

        def decode(self, cache, tokens, pos):
            return self._timed("decode", super().decode, cache, tokens, pos)

        def times(self, kind):
            """([device ms], [host enqueue ms]) of each call since the last reset."""
            torch.cuda.synchronize()
            evs = self.events[kind]
            return [s.elapsed_time(e) for s, e, _ in evs], [h for _, _, h in evs]
    return TimedServe


def logit_check(torch, got, want):
    """(max |got - want|, share of MODEL_LOGIT_LIMIT, both finite)."""
    err = float((got.float() - want.float()).abs().max())
    finite = bool(torch.isfinite(got.float()).all() and torch.isfinite(want.float()).all())
    return err, err / MODEL_LOGIT_LIMIT, finite


def teacher_forced(torch, models, cfg, params, prompt, tokens):
    """The forward's logits at the positions ``generate`` produced its
    tokens from: prompt + all generated tokens but the last."""
    full = torch.cat([prompt, tokens[:, :-1]], dim=1)
    with torch.no_grad():
        return models.forward(cfg, params, {"tokens": full})[0][:, prompt.shape[1] - 1:], full


def granite_serve(torch, cfgs, models, api, serve_mod, tree_mod):
    """granite-8b at its published widths and depth, bf16, random weights
    from ``init_params(seed 0)``: MODEL_BATCH prompts of MODEL_PROMPT tokens
    served by ``ServeModel.generate`` (prefill, then greedy decode) with
    MODEL_NEW new tokens each. Timed: the prefill and each decode step
    (CUDA events, host clock beside), the whole call (host clock). After
    the timed window: the same call again must give the same tokens and
    logits bit for bit, and every logit is finite. The teacher-forced
    forward over prompt + generated tokens is compared and reported, not
    held: at this depth the reference's initialisation makes the function
    ill-conditioned (attention logits of std about 255, so attention is
    hard and one rounding flips it), and the same forward with attn_chunk
    halved, the same function summed in another order, is reported beside
    it. ``held_check`` holds the comparison at one layer."""
    cfg = cfgs.get_config(MODEL_ARCH)
    B, L, N = MODEL_BATCH, MODEL_PROMPT, MODEL_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = models.init_params(models.param_specs(cfg), SEED, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    leaves = tree_mod.leaves(params)
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    tok = params["embed"]["tok"]
    tok_params, tok_bytes = tok.numel(), tok.numel() * tok.element_size()
    del leaves, tok
    TimedServe = timed_serve(torch, serve_mod.ServeModel)
    model = TimedServe(cfg, params, device=DEVICE)
    del params
    batch = api.make_batch(cfg, B, L, seed=SEED, device=DEVICE)
    model.generate({"tokens": batch["tokens"][:, :64]}, 2)      # warm-up
    model.events = {"prefill": [], "decode": []}
    torch.cuda.synchronize()
    t = time.perf_counter()
    tokens, logits = model.generate(batch, N)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    (prefill_ms,), (prefill_host_ms,) = model.times("prefill")
    step_ms, step_host_ms = model.times("decode")
    check(len(step_ms) == N - 1, f"{len(step_ms)} decode steps for {N} tokens")
    check(tuple(tokens.shape) == (B, N) and tokens.dtype == torch.int32
          and tokens.device.type == torch.device(DEVICE).type,
          f"tokens {tuple(tokens.shape)} {tokens.dtype} on {tokens.device}")
    check(tuple(logits.shape) == (B, N, cfg.vocab_size), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "a token outside the vocabulary")
    again_tokens, again_logits = model.generate(batch, N)
    same = bool(torch.equal(again_tokens, tokens) and torch.equal(again_logits, logits))
    check(same, "a second generate of the same prompts differs")
    del again_tokens, again_logits
    ref, full = teacher_forced(torch, models, cfg, model.tree(), batch["tokens"], tokens)
    with torch.no_grad():
        half = models.forward(cfg.replace(attn_chunk=cfg.attn_chunk // 2), model.tree(),
                              {"tokens": full})[0][:, L - 1:]

    def spread(a, b):
        d = (a.float() - b.float()).abs()
        return dict(max_abs=float(d.max()), rms=float(d.pow(2).mean().sqrt()),
                    argmax_agrees=float((a.argmax(-1) == b.argmax(-1)).float().mean()))
    conditioning = dict(logit_rms=float(ref.float().pow(2).mean().sqrt()),
                        decode_vs_forward=spread(logits, ref),
                        forward_vs_forward_half_chunk=spread(half, ref),
                        prefill_vs_forward_max_abs=float(
                            (logits[:, 0].float() - ref[:, 0].float()).abs().max()))
    del ref, half, full

    # where the time goes: one prefill and one decode step under the
    # profiler (device time by kernel; the rest of the event time is idle)
    def top(names, n=8):
        return dict(sorted(names.items(), key=lambda kv: -kv[1])[:n])
    cache = models.init_params(models.cache_specs(cfg, B, L + N), 0, DEVICE)
    step_tokens = tokens[:, :1].contiguous()
    prefill_dev, prefill_kernels, prefill_launches = profiled_ms(
        torch, lambda: model.prefill(batch), reps=1, warmup=1)
    step_dev, step_kernels, step_launches = profiled_ms(
        torch, lambda: model.decode(cache, step_tokens, L), reps=3, warmup=1)
    profile = dict(prefill_device_ms=prefill_dev, prefill_launches=prefill_launches,
                   prefill_top_kernels_ms=top(prefill_kernels),
                   decode_step_device_ms=step_dev, decode_step_launches=step_launches,
                   decode_step_top_kernels_ms=top(step_kernels),
                   decode_step_idle_share=None if step_dev is None
                   else 1 - step_dev / statistics.median(step_ms))
    del cache

    # bounds: the step's bytes (every weight but the embedding table, B of
    # its rows, the K/V of the positions this step attends to, the logits
    # out); the prefill's operations (2 per weight and token in the
    # products, and q.k and p.v over the causal pairs)
    d, H, KV, hd, layers = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    kv_bytes = [2 * layers * B * (p + 1) * KV * hd * 2 for p in range(L, L + N - 1)]
    step_bytes = [param_bytes - tok_bytes + B * d * 2 + kv + B * cfg.vocab_size * 2
                  for kv in kv_bytes]
    step_bound_ms = statistics.mean(step_bytes) / HBM_BYTES_PER_S * 1e3
    prefill_ops = (2 * (n_params - tok_params) * B * L
                   + 4 * B * H * hd * (L * (L + 1) // 2) * layers)
    prefill_bound_ms = prefill_ops / BF16_TENSOR_OPS_PER_S * 1e3
    step_med = statistics.median(step_ms)
    out = dict(
        config=dict(arch=MODEL_ARCH, layers=layers, d_model=d, heads=H, kv_heads=KV,
                    head_dim=hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype="bfloat16",
                    parameters=n_params, parameter_bytes=param_bytes),
        requests=dict(batch=B, prompt_tokens=L, new_tokens=N, decode_steps=N - 1,
                      cache_positions=L + N, cache_bytes=2 * layers * B * (L + N) * KV * hd * 2),
        init_seconds=init_s, generate_seconds=generate_s,
        prefill_ms=prefill_ms, prefill_host_ms=prefill_host_ms,
        prefill_tokens_per_s=B * L / prefill_ms * 1e3,
        prefill_bound_ms=prefill_bound_ms, prefill_bound_by="operations",
        prefill_operations=prefill_ops, prefill_share_of_bound=prefill_bound_ms / prefill_ms,
        decode_step_ms=dict(median=step_med, min=min(step_ms), max=max(step_ms),
                            spread=max(step_ms) - min(step_ms),
                            p90=statistics.quantiles(step_ms, n=10)[-1]),
        decode_step_host_ms=dict(median=statistics.median(step_host_ms), max=max(step_host_ms)),
        decode_steps_ms=step_ms,
        decode_tokens_per_s=B / step_med * 1e3,
        decode_step_bytes=statistics.mean(step_bytes), decode_step_bound_ms=step_bound_ms,
        decode_bound_by="bytes", decode_share_of_bound=step_bound_ms / step_med,
        max_memory_allocated=peak, finite=True, repeat_bit_identical=same,
        conditioning=conditioning, profile=profile)
    del model, logits, tokens, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def held_check(torch, cfgs, models, api, serve_mod):
    """The serve shape (MODEL_BATCH x MODEL_PROMPT, MODEL_NEW new tokens,
    bf16, published widths) cut to one layer, where the function is
    well-conditioned: every logit of ``generate`` within MODEL_LOGIT_LIMIT
    of the teacher-forced forward, and a planted fault (each decode step
    one position late: its rope and its cache slot) that the same check
    must reject."""
    cfg = cfgs.get_config(MODEL_ARCH).replace(num_layers=1)
    B, L, N = MODEL_BATCH, MODEL_PROMPT, MODEL_NEW
    params = models.init_params(models.param_specs(cfg), SEED, DEVICE)
    batch = api.make_batch(cfg, B, L, seed=SEED, device=DEVICE)
    tokens, logits = serve_mod.ServeModel(cfg, params, device=DEVICE).generate(batch, N)
    ref, _ = teacher_forced(torch, models, cfg, params, batch["tokens"], tokens)
    err, share, finite = logit_check(torch, logits, ref)
    largest = float(ref.float().abs().max())
    per_step = (logits.float() - ref.float()).abs().amax(dim=(0, 2)).tolist()
    check(finite, "non-finite logits at one layer")
    check(largest < 8, f"logits up to {largest:.3g}: MODEL_LOGIT_LIMIT assumes |logit| < 8")
    check(share <= 1.0, f"one layer: decode logits {err:.4g} from the teacher-forced forward "
                        f"(limit {MODEL_LOGIT_LIMIT})")

    class LateDecode(serve_mod.ServeModel):
        def decode(self, cache, tokens, pos):
            return super().decode(cache, tokens, pos + 1)
    f_tokens, f_logits = LateDecode(cfg, params, device=DEVICE).generate(batch, MODEL_FAULT_NEW)
    f_ref, _ = teacher_forced(torch, models, cfg, params, batch["tokens"], f_tokens)
    f_err, f_share, _ = logit_check(torch, f_logits[:, 1:], f_ref[:, 1:])
    check(f_share > 1.0, f"a decode one position late passed the check ({f_err:.4g})")
    out = dict(cut={"num_layers": 1}, max_abs_err=err, limit=MODEL_LOGIT_LIMIT,
               share_of_limit=share, per_step_max_abs_err=per_step, largest_logit=largest,
               finite=finite, planted_late_decode=dict(max_abs_err=f_err, share_of_limit=f_share),
               layer0_attention=attention_stats(torch, cfg, params, batch["tokens"][:1, :256]))
    del params, batch, tokens, logits, ref, f_logits, f_ref
    # how the disagreement grows with depth (reported, not held)
    sweep = {}
    for n in CONDITIONING_DEPTHS:
        cfg_n = cfg.replace(num_layers=n)
        params = models.init_params(models.param_specs(cfg_n), SEED, DEVICE)
        batch = api.make_batch(cfg_n, B, L, seed=SEED, device=DEVICE)
        tokens, logits = serve_mod.ServeModel(cfg_n, params, device=DEVICE).generate(batch, 8)
        ref, _ = teacher_forced(torch, models, cfg_n, params, batch["tokens"], tokens)
        d = (logits.float() - ref.float()).abs()
        sweep[n] = dict(max_abs=float(d.max()), rms=float(d.pow(2).mean().sqrt()))
        del params, batch, tokens, logits, ref, d
    out["decode_vs_forward_by_depth"] = sweep
    gc.collect()
    torch.cuda.empty_cache()
    return out


def attention_stats(torch, cfg, params, tokens):
    """Layer 0's causal attention logits (q.k / sqrt(hd), the first query
    head of each KV head) on ``tokens`` [1, T]: their std, and the smallest
    gap between a query's two largest (near-ties flip hard attention)."""
    from repro_torch.models import attention, common, transformer
    with torch.no_grad():
        T = tokens.shape[1]
        p = {k: v[0] for k, v in params["segments"][0]["k0_attn_mlp"]["attn"].items()}
        ln = {k: v[0] for k, v in params["segments"][0]["k0_attn_mlp"]["ln1"].items()}
        h = common.apply_norm(cfg, ln, transformer._embed_tokens(cfg, params, tokens))
        pos = torch.arange(T, device=tokens.device)[None]
        q = attention._project_q(cfg, p, h, pos).float()
        k = attention._project_kv(cfg, p, h, pos)[0].float()
        G = cfg.num_heads // cfg.num_kv_heads
        lg = torch.einsum("lhd,shd->hls", q[0, :, ::G], k[0]) * cfg.head_dim ** -0.5
        causal = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
        top2 = lg.masked_fill(~causal, -float("inf")).topk(2, dim=-1).values[:, 1:]
        return dict(tokens=T, logit_std=float(lg[:, causal].std()),
                    min_top2_gap=float((top2[..., 0] - top2[..., 1]).min()))


def exact_share(got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 passes rtol = atol = tol."""
    return float(((got.double() - want.double()).abs()
                  / (tol + tol * want.double().abs())).max())


def exact_checks(torch, cfgs, models, api, serve_mod, tree_mod):
    """Float32 at published widths, depth cut to EXACT_LAYERS. Where the
    reference's tests run it (DECODE_CONSISTENCY_ARCHS), token-by-token
    decode over EXACT_T tokens against the teacher-forced forward at 2e-3;
    for granite-8b also prefill(8) then 4 decode steps at 5e-3 and the
    card's forward against the port's CPU forward with the same weights at
    CARD_VS_CPU_TOL; for the other two, shapes and finite values of forward
    and two decode steps. TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, cut in EXACT_LAYERS.items():
        t = time.perf_counter()
        cfg = cfgs.get_config(arch).replace(compute_dtype="float32", param_dtype="float32",
                                            **cut)
        if cfg.family == "moe":      # no routing drops, as the reference's test
            cfg = cfg.replace(moe_capacity_factor=float(cfg.num_experts / cfg.moe_top_k))
        torch.cuda.reset_peak_memory_stats()
        specs = tree_mod.tree_map(lambda s: replace(s, dtype=torch.float32),
                                  models.param_specs(cfg),
                                  is_leaf=lambda x: isinstance(x, models.ParamSpec))
        params = models.init_params(specs, SEED, DEVICE)
        n_params = sum(x.numel() for x in tree_mod.leaves(params))
        T = EXACT_T
        batch = api.make_batch(cfg, 1, T, seed=3, device=DEVICE)
        row = dict(cut=cut, parameters=n_params)
        with torch.no_grad():
            ref, aux, _ = models.forward(cfg, params, batch)
            check(tuple(ref.shape) == (1, T, cfg.vocab_size), f"{arch}: logits {tuple(ref.shape)}")
            check(bool(torch.isfinite(ref).all()) and bool(torch.isfinite(aux)),
                  f"{arch}: non-finite forward")
            cache = models.init_params(models.cache_specs(cfg, 1, T), 0, DEVICE)
            steps = T if arch in DECODE_CONSISTENCY_ARCHS else 2
            share = 0.0
            for i in range(steps):
                logits, cache = models.decode_step(cfg, params, cache,
                                                   batch["tokens"][:, i:i + 1], i)
                check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite decode at {i}")
                if arch in DECODE_CONSISTENCY_ARCHS:
                    share = max(share, exact_share(logits, ref[:, i], 2e-3))
            if arch in DECODE_CONSISTENCY_ARCHS:
                row["decode_vs_forward_share_of_2e-3"] = share
                check(share <= 1.0, f"{arch}: decode diverges from forward ({share:.3g} of 2e-3)")
            if arch == MODEL_ARCH:
                row.update(granite_handoff(torch, cfg, params, models, api, serve_mod, tree_mod))
        row.update(seconds=time.perf_counter() - t, max_memory_allocated=torch.cuda.max_memory_allocated())
        out[arch] = row
        del params, cache, ref, logits, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def granite_handoff(torch, cfg, params, models, api, serve_mod, tree_mod):
    """prefill(8) then 4 decode steps against forward at 5e-3; the card's
    forward against the CPU's at CARD_VS_CPU_TOL (the same weights, copied)."""
    T, extra = 8, 4
    full = api.make_batch(cfg, 1, T + extra, seed=5, device=DEVICE)
    ref = models.forward(cfg, params, full)[0]
    last, pre = serve_mod.make_prefill_step(cfg)(params, {"tokens": full["tokens"][:, :T]})
    share = exact_share(last, ref[:, T - 1], 5e-3)
    cache = models.init_params(models.cache_specs(cfg, 1, T + extra), 0, DEVICE)

    def fit(p, z):
        z[tuple(slice(0, s) for s in p.shape)] = p
        return z
    cache = tree_mod.tree_map(fit, pre, cache)
    for t in range(T, T + extra):
        logits, cache = models.decode_step(cfg, params, cache, full["tokens"][:, t:t + 1], t)
        share = max(share, exact_share(logits, ref[:, t], 5e-3))
    check(share <= 1.0, f"granite prefill->decode diverges ({share:.3g} of 5e-3)")
    host = tree_mod.tree_map(lambda x: x.cpu(), params)
    cpu = models.forward(cfg, host, {"tokens": full["tokens"].cpu()})[0]
    cpu_share = exact_share(ref.cpu(), cpu, CARD_VS_CPU_TOL)
    check(cpu_share <= 1.0,
          f"granite card forward vs CPU forward ({cpu_share:.3g} of {CARD_VS_CPU_TOL})")
    one = cfg.replace(num_layers=1)
    host1 = dict(host, segments=[tree_mod.tree_map(lambda x: x[:1], host["segments"][0])])
    card1 = dict(params, segments=[tree_mod.tree_map(lambda x: x[:1], params["segments"][0])])
    cpu1 = models.forward(one, host1, {"tokens": full["tokens"].cpu()})[0]
    ref1 = models.forward(one, card1, full)[0].cpu()
    return {"prefill_then_decode_share_of_5e-3": share,
            "card_vs_cpu_1_layer_share_of_1e-4": exact_share(ref1, cpu1, 1e-4),
            f"card_vs_cpu_share_of_{CARD_VS_CPU_TOL}": cpu_share,
            "card_vs_cpu_share_of_1e-4": exact_share(ref.cpu(), cpu, 1e-4),
            "card_vs_cpu_max_abs": float((ref.cpu().double() - cpu.double()).abs().max())}


def phase_model(torch, cfgs, models, api, serve_mod, tree_mod, counted, card):
    """The model serve stack on the card: granite_serve, held_check, then
    exact_checks.
    No hand-written kernel of the port is on this path: each wrapper's
    count is set to 0 before and read after, and must stay 0."""
    t_phase = time.perf_counter()
    for fn in counted:
        fn.launches = 0
    serve = granite_serve(torch, cfgs, models, api, serve_mod, tree_mod)
    held = held_check(torch, cfgs, models, api, serve_mod)
    exact = exact_checks(torch, cfgs, models, api, serve_mod, tree_mod)
    launches = {fn.__name__: fn.launches for fn in counted}
    check(not any(launches.values()), f"kernels launched on the model path: {launches}")
    emit("model", card=card, serve=serve, held_check=held, exact=exact,
         kernel_launches=launches,
         cuts={MODEL_ARCH + " serve": "none (36 layers, published widths)",
               MODEL_ARCH + " held check": {"num_layers": 1},
               **{a: c for a, c in EXACT_LAYERS.items()}},
         seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------------------ training

def leaf_shares(torch, got, want, tol):
    """Each leaf's ||got - want|| / (tol ||want||), in leaf order (a leaf
    whose ``want`` is zero must be zero in ``got``), in float64 on the card."""
    out = []
    for a, b in zip(got, want):
        a, b = a.to(DEVICE, torch.float64), b.to(DEVICE, torch.float64)
        norm = float(b.norm())
        out.append(float((a - b).norm()) / (tol * norm) if norm else float(a.abs().max() > 0))
    return out


def train_main_run(torch, launch, models, step_mod, opt_mod, tree_mod):
    """h2o-danube-1.8b at its published widths and depth through
    ``launch.build``: the corpus, ZoneDataPipeline -> PrefetchLoader ->
    Trainer on the card. TRAIN_STEPS steps with CUDA events around each
    step call (the host clock beside: its enqueue, and the trainer's own
    step seconds, which end at the metrics' read). Then one step on the
    last batch under the profiler, and that batch's loss after it."""
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--grad-accum", str(TRAIN_ACCUM), "--lr", str(TRAIN_LR),
            "--warmup-steps", "1", "--device", DEVICE]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run = launch.build(launch.parse_args(argv))
    build_s = time.perf_counter() - t
    cfg, trainer = run.cfg, run.trainer
    inner, events, last = trainer.step_fn, [], {}

    def timed(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(state, batch)
        end.record()
        events.append((start, end, (time.perf_counter() - t0) * 1e3))
        last["batch"] = batch
        return out
    trainer.step_fn = timed
    t = time.perf_counter()
    trainer.run(run.batches)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    check(len(hist) == TRAIN_STEPS, f"{len(hist)} steps of {TRAIN_STEPS}")
    step_ms = [s.elapsed_time(e) for s, e, _ in events]
    enqueue_ms = [h for _, _, h in events]
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(0.1 < losses[0] < 3 * np.log(cfg.vocab_size),
          f"first loss {losses[0]:.4g} outside (0.1, 3 ln V)")
    params = trainer.state["params"]
    leaves = tree_mod.leaves(params)
    n_params = sum(x.numel() for x in leaves)
    tok_params = params["embed"]["tok"].numel()
    state_bytes = sum(x.numel() * x.element_size() for x in tree_mod.leaves(trainer.state))
    del leaves, params

    # one more step on the last batch (its own schedule: the run's has
    # decayed to 0 by its last step) under the profiler, and that batch's
    # loss after it. Reported, not held: at this depth the reference's
    # initialisation makes the gradient explode (grad norms of order 1e17),
    # and train_loss_check holds the loss's fall at two layers
    batch = last.pop("batch")
    one_step = step_mod.make_train_step(cfg, step_mod.TrainHyper(
        grad_accum=TRAIN_ACCUM, adamw=opt_mod.AdamWHyper(lr=TRAIN_LR, warmup_steps=1,
                                                         total_steps=100)))
    mets = []
    t = time.perf_counter()
    dev_ms, kernels, launches = profiled_ms(
        torch, lambda: mets.append(one_step(trainer.state, batch)[1]), reps=1, warmup=0)
    profile_s = time.perf_counter() - t
    with torch.no_grad():
        after = float(models.loss_fn(cfg, trainer.state["params"], batch)[0])
    mets = {k: float(v) for k, v in mets[0].items()}
    check(np.isfinite([mets["loss"], mets["grad_norm"], after]).all(),
          "non-finite loss or grad norm in the profiled step")

    # the bound: 6 operations a non-embedding parameter and token, and the
    # causal attention's 6 L^2 H hd a sequence and layer, at the dense bf16 rate
    B, L, H, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.head_dim
    ops = 6 * (n_params - tok_params) * B * L + 6 * L * L * H * hd * cfg.num_layers * B
    bound = ops / BF16_TENSOR_OPS_PER_S * 1e3
    timed_ms = step_ms[1:]
    med = statistics.median(timed_ms)
    out = dict(
        config=dict(arch=TRAIN_ARCH, layers=cfg.num_layers, d_model=cfg.d_model, heads=H,
                    kv_heads=cfg.num_kv_heads, head_dim=hd, d_ff=cfg.d_ff,
                    vocab=cfg.vocab_size, sliding_window=cfg.sliding_window,
                    dtype=cfg.param_dtype, remat=cfg.remat, attn_chunk=cfg.attn_chunk,
                    parameters=n_params, train_state_bytes=state_bytes),
        run=dict(batch=B, seq=L, grad_accum=TRAIN_ACCUM, tokens_per_step=B * L,
                 lr=TRAIN_LR, warmup_steps=1, steps=TRAIN_STEPS, untimed_steps=1),
        build_seconds=build_s, run_seconds=run_s,
        step_ms=step_ms, step_ms_median=med, step_ms_min=min(timed_ms),
        step_ms_max=max(timed_ms), step_enqueue_ms=enqueue_ms,
        step_host_seconds=[h["step_seconds"] for h in hist],
        tokens_per_s=B * L / med * 1e3, operations=ops, bound_ms=bound,
        bound_by="operations", share_of_bound=bound / med,
        max_memory_allocated=peak, losses=losses, grad_norms=norms,
        lrs=[h["lr"] for h in hist],
        profiled_step=dict(loss_before=mets["loss"], loss_after=after,
                           grad_norm=mets["grad_norm"], lr=mets["lr"]),
        profile=dict(seconds=profile_s, step_device_ms=dev_ms, step_launches=launches,
                     step_idle_share=None if dev_ms is None else 1 - dev_ms / med,
                     top_kernels_ms=dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])))
    del run, trainer, batch, one_step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _init_one_layer(torch, cfgs, models, tree_mod, dtype):
    """h2o-danube-1.8b at published widths cut to GRAD_CHECK's one layer,
    in ``dtype``, with init_params(SEED)'s weights on the card."""
    cfg = cfgs.get_config(TRAIN_ARCH).replace(num_layers=GRAD_CHECK["num_layers"],
                                              compute_dtype=dtype, param_dtype=dtype)
    specs = tree_mod.tree_map(lambda s: replace(s, dtype=getattr(torch, dtype)),
                              models.param_specs(cfg),
                              is_leaf=lambda x: isinstance(x, models.ParamSpec))
    return cfg, models.init_params(specs, SEED, DEVICE)


def train_grad_check(torch, cfgs, models, api, step_mod, opt_mod, tree_mod):
    """h2o-danube-1.8b at published widths cut to one layer, float32, TF32
    off: one ``make_train_step`` (from step 1, so its lr is not 0) on the
    card and on the CPU with the same weights and batch. Each leaf's
    gradient (as the step's ``loss_and_grads`` returns it), m, v and
    updated parameters within GRAD_TOL (v: twice it) of the CPU's, relative
    L2; and a leaf's gradient scaled by 1 + GRAD_FAULT, which must fail.
    The update p - p0 is held within UPDATE_TOL on the elements whose CPU
    gradient is above its leaf's floor (the others are counted): below it
    an element that is rounding noise around zero may take either sign on
    either device and move by 2 lr. An update scaled by 1 + GRAD_FAULT must
    fail that."""
    t_check = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, card_params = _init_one_layer(torch, cfgs, models, tree_mod, "float32")
    batch = api.make_batch(cfg, GRAD_CHECK["batch"], GRAD_CHECK["seq"], seed=SEED, device=DEVICE)
    hyper = step_mod.TrainHyper(adamw=opt_mod.AdamWHyper(lr=TRAIN_LR, warmup_steps=1,
                                                         total_steps=10))
    real = step_mod.loss_and_grads
    runs = {}
    host_params = tree_mod.tree_map(lambda x: x.to("cpu", copy=True), card_params)
    host_params_f32 = tree_mod.tree_map(lambda x: x.to(DEVICE, copy=True), card_params)
    for where, params in (("card", card_params), ("cpu", host_params)):
        p0 = tree_mod.tree_map(lambda x: x.clone(), params)
        state = {"params": params,
                 "m": tree_mod.tree_map(torch.zeros_like, params),
                 "v": tree_mod.tree_map(torch.zeros_like, params),
                 "step": torch.ones((), dtype=torch.int32, device=params["final_norm"]["scale"].device)}
        seen = []

        def recording(*args, **kw):
            out = real(*args, **kw)
            seen.append(out[2])
            return out
        step_mod.loss_and_grads = recording
        try:
            t = time.perf_counter()
            state, mets = step_mod.make_train_step(cfg, hyper)(
                state, {k: v.to(params["final_norm"]["scale"].device) for k, v in batch.items()})
            loss = float(mets["loss"])
            seconds = time.perf_counter() - t
        finally:
            step_mod.loss_and_grads = real
        runs[where] = dict(grads=seen[0], m=tree_mod.leaves(state["m"]),
                           v=tree_mod.leaves(state["v"]), params=tree_mod.leaves(state["params"]),
                           update=[a - b for a, b in zip(tree_mod.leaves(state["params"]),
                                                         tree_mod.leaves(p0))],
                           loss=loss, grad_norm=float(mets["grad_norm"]), seconds=seconds)
    card, cpu = runs["card"], runs["cpu"]
    paths = [tree_mod.keystr(p) for p, _ in tree_mod.flatten_with_path(card_params)[0]]
    # the bounds' premises: each float32 gradient's relative L2 distance
    # from float64's (the same weights and batch, on the card), and its
    # largest element distance over its leaf's rms
    cfg64 = cfg.replace(compute_dtype="float64", param_dtype="float64")
    _, _, g64 = real(cfg64, tree_mod.tree_map(lambda x: x.double(), host_params_f32),
                     {k: v.to(DEVICE) for k, v in batch.items()})
    f64_dist = {where: max(leaf_shares(torch, runs[where]["grads"], g64, 1.0))
                for where in ("card", "cpu")}
    f64_elem = {where: [float((a.to(DEVICE, torch.float64) - b).abs().max()
                              / b.pow(2).mean().sqrt()) for a, b in zip(runs[where]["grads"], g64)]
                for where in ("card", "cpu")}
    del g64
    shares = {name: leaf_shares(torch, card[name], cpu[name], GRAD_TOL * (2 if name == "v" else 1))
              for name in ("grads", "m", "v", "params")}
    worst = {name: dict(share=max(s), leaf=paths[int(np.argmax(s))]) for name, s in shares.items()}
    for name in ("grads", "m", "v", "params"):
        w = worst[name]
        check(w["share"] <= 1.0, f"card {name} vs CPU: {w['leaf']} at {w['share']:.3g} of the bound")
    planted = list(card["grads"])
    planted[0] = planted[0] * (1 + GRAD_FAULT)
    fault = leaf_shares(torch, planted[:1], cpu["grads"][:1], GRAD_TOL)[0]
    check(fault > 1.0, f"a gradient scaled by 1 + {GRAD_FAULT} passed ({fault:.3g} of the bound)")

    # the update, on the elements whose CPU gradient is above its leaf's
    # floor: 4 n rms, n the larger device's largest float32 element
    # distance from float64 in that leaf, and at least UPDATE_FLOOR rms
    floors = [max(UPDATE_FLOOR, 4 * max(a, b)) for a, b in zip(f64_elem["card"], f64_elem["cpu"])]
    kept = []
    for g, floor in zip(cpu["grads"], floors):
        g = g.to(DEVICE, torch.float64)
        kept.append(g.abs() > floor * g.pow(2).mean().sqrt())
    excluded = sum(int((~k).sum()) for k in kept)
    upd = [(a.to(DEVICE, torch.float64)[k], b.to(DEVICE, torch.float64)[k])
           for a, b, k in zip(card["update"], cpu["update"], kept)]
    upd_shares = leaf_shares(torch, [a for a, _ in upd], [b for _, b in upd], UPDATE_TOL)
    upd_worst = dict(share=max(upd_shares), leaf=paths[int(np.argmax(upd_shares))])
    check(upd_worst["share"] <= 1.0,
          f"card update vs CPU: {upd_worst['leaf']} at {upd_worst['share']:.3g} of the bound")
    upd_fault = max(leaf_shares(torch, [a * (1 + GRAD_FAULT) for a, _ in upd],
                                [b for _, b in upd], UPDATE_TOL))
    check(upd_fault > 1.0, f"an update scaled by 1 + {GRAD_FAULT} passed "
                           f"({upd_fault:.3g} of the bound)")
    all_upd = leaf_shares(torch, card["update"], cpu["update"], UPDATE_TOL)
    out = dict(cut=GRAD_CHECK, dtype="float32", tf32=False, tol=GRAD_TOL,
               worst_share=worst,
               f32_vs_f64_max_relative=f64_dist,
               f32_vs_f64_max_element_over_rms={w: dict(zip(paths, f64_elem[w]))
                                                for w in ("card", "cpu")},
               update=dict(tol=UPDATE_TOL, floor_over_rms=dict(zip(paths, floors)),
                           worst_share=upd_worst,
                           elements=sum(k.numel() for k in kept), excluded=excluded,
                           excluded_by_leaf=dict(zip(paths, [int((~k).sum()) for k in kept])),
                           planted_share=upd_fault,
                           all_elements_worst_share=dict(
                               share=max(all_upd), leaf=paths[int(np.argmax(all_upd))])),
               grads_share_by_leaf=dict(zip(paths, shares["grads"])),
               loss=dict(card=card["loss"], cpu=cpu["loss"]),
               grad_norm=dict(card=card["grad_norm"], cpu=cpu["grad_norm"]),
               step_seconds=dict(card=card["seconds"], cpu=cpu["seconds"]),
               planted_fault=dict(leaf=paths[0], scale=1 + GRAD_FAULT, share=fault),
               seconds=time.perf_counter() - t_check)
    del runs, card, cpu, planted, card_params, host_params, host_params_f32, batch, kept, upd
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_grad_check_bf16(torch, cfgs, models, api, step_mod, tree_mod):
    """The main path's dtype: ``loss_and_grads`` of h2o-danube-1.8b at
    published widths cut to one layer, bf16, on the card and on the CPU
    with the same weights and batch, and in float32 (TF32 off) on the card
    from the same bf16 weights. Each card leaf within its bound of the
    CPU's: BF16_TOL, or twice the CPU's own relative distance from the
    float32 gradient where that is larger; a leaf that is zero in float32
    below BF16_NOISE of the whole. A leaf scaled by 1 + 10 x its bound must
    fail."""
    t_check = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, card_params = _init_one_layer(torch, cfgs, models, tree_mod, "bfloat16")
    batch = api.make_batch(cfg, GRAD_CHECK["batch"], GRAD_CHECK["seq"], seed=SEED, device=DEVICE)
    host_params = tree_mod.tree_map(lambda x: x.to("cpu", copy=True), card_params)
    t = time.perf_counter()
    loss_card, _, g_card = step_mod.loss_and_grads(cfg, card_params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    loss_cpu, _, g_cpu = step_mod.loss_and_grads(
        cfg, host_params, {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t
    cfg32 = cfg.replace(compute_dtype="float32", param_dtype="float32")
    _, _, g32 = step_mod.loss_and_grads(
        cfg32, tree_mod.tree_map(lambda x: x.float(), card_params), batch)
    g32 = [g.double() for g in g32]
    whole = math.sqrt(sum(float(g.pow(2).sum()) for g in g32))
    own = leaf_shares(torch, g_cpu, g32, 1.0)
    tols = [max(BF16_TOL, 2 * d) for d in own]
    shares = []
    for a, b, t32, tol in zip(g_card, g_cpu, g32, tols):
        if float(t32.norm()) < 1e-6 * whole:
            shares.append(float(a.double().norm()) / (BF16_NOISE * whole))
        else:
            shares.append(leaf_shares(torch, [a], [b], tol)[0])
    paths = [tree_mod.keystr(p) for p, _ in tree_mod.flatten_with_path(card_params)[0]]
    i = int(np.argmax(shares))
    check(np.isfinite([float(loss_card), float(loss_cpu)]).all(), "non-finite bf16 loss")
    check(shares[i] <= 1.0, f"card bf16 gradient vs CPU: {paths[i]} at {shares[i]:.3g} "
                            f"of {tols[i]:.3g}")
    fault = leaf_shares(torch, [g_card[0] * (1 + 10 * tols[0])], g_cpu[:1], tols[0])[0]
    check(fault > 1.0, f"a bf16 gradient scaled by 1 + 10 x its bound passed ({fault:.3g})")
    out = dict(cut=GRAD_CHECK, dtype="bfloat16", tol_floor=BF16_TOL,
               worst_share=dict(share=shares[i], leaf=paths[i], tol=tols[i]),
               by_leaf={p: dict(share=s, tol=t, cpu_vs_f32=d)
                        for p, s, t, d in zip(paths, shares, tols, own)},
               loss=dict(card=float(loss_card), cpu=float(loss_cpu)),
               seconds=dict(card=card_s, cpu=cpu_s, check=time.perf_counter() - t_check),
               planted_fault=dict(leaf=paths[0], scale=1 + 10 * tols[0], share=fault))
    del card_params, host_params, g_card, g_cpu, g32, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_loss_check(torch, cfgs, models, step_mod, opt_mod):
    """The loss falls on one repeated batch: h2o-danube-1.8b at published
    widths cut to RESUME_LAYERS layers, bf16, one RESUME_BATCH x TRAIN_SEQ
    batch, TRAIN_REPEAT steps at TRAIN_LR (warm-up 1, so the first step's
    lr is 0); the batch's loss after them below the first step's. At 24
    layers the reference's initialisation makes the gradient explode (the
    train line's grad norms) and the loss does not move in a few steps."""
    t_check = time.perf_counter()
    cfg = cfgs.get_config(TRAIN_ARCH).replace(num_layers=RESUME_LAYERS)
    state = step_mod.init_state(cfg, SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (RESUME_BATCH, TRAIN_SEQ),
                                              dtype=np.int32)).to(DEVICE)
             for k in ("tokens", "labels")}
    step = step_mod.make_train_step(cfg, step_mod.TrainHyper(
        adamw=opt_mod.AdamWHyper(lr=TRAIN_LR, warmup_steps=1, total_steps=100)))
    mets = [{k: float(v) for k, v in step(state, batch)[1].items()} for _ in range(TRAIN_REPEAT)]
    with torch.no_grad():
        after = float(models.loss_fn(cfg, state["params"], batch)[0])
    losses = [m["loss"] for m in mets]
    check(np.isfinite(losses + [m["grad_norm"] for m in mets] + [after]).all(),
          "non-finite loss or grad norm on the repeated batch")
    check(after < losses[0], f"the repeated batch's loss {losses[0]:.4g} -> {after:.4g} "
                             f"after {TRAIN_REPEAT} steps")
    out = dict(cut={"num_layers": RESUME_LAYERS}, batch=RESUME_BATCH, seq=TRAIN_SEQ,
               losses=losses, grad_norms=[m["grad_norm"] for m in mets],
               lrs=[m["lr"] for m in mets], loss_after=after,
               seconds=time.perf_counter() - t_check)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


class StoreAt:
    """A checkpoint store as it stood at ``step``, read-only: a trainer
    resuming from it restores that step and saves nothing."""

    def __init__(self, store, step):
        self.store, self.step = store, step

    def latest_step(self):
        return self.step

    def restore(self, *, like, shardings=None, torch_device=None):
        return self.store.restore(self.step, like=like, shardings=shardings,
                                  torch_device=torch_device)

    def save(self, step, tree):
        pass

    def flush(self):
        pass


def train_resume_check(torch, cfgs, ZonedDevice, train_mod, step_mod, opt_mod, trainer_mod,
                       tree_mod):
    """tests/test_checkpoint.py::test_preemption_exact_resume at published
    widths cut to RESUME_LAYERS layers, bf16, RESUME_BATCH x TRAIN_SEQ
    tokens: RESUME_STEPS steps straight against half of them, a save through
    ZonedCheckpointStore, a fresh Trainer restoring onto the card, and the
    other half; step, params, m and v must be torch.equal. The planted
    fault: the same resume fed the pipeline from its start again (no
    replay), which must differ. Under deterministic algorithms (the
    gathers' backward would otherwise accumulate with atomics), with
    CUBLAS_WORKSPACE_CONFIG set before the process's first cuBLAS call
    (``main``)."""
    cfg = cfgs.get_config(TRAIN_ARCH).replace(num_layers=RESUME_LAYERS)
    rng = np.random.default_rng(SEED)
    batches = [{k: rng.integers(0, cfg.vocab_size, (RESUME_BATCH, TRAIN_SEQ), dtype=np.int32)
                for k in ("tokens", "labels")} for _ in range(RESUME_STEPS)]
    half = RESUME_STEPS // 2
    hyper = step_mod.TrainHyper(adamw=opt_mod.AdamWHyper(lr=TRAIN_LR, warmup_steps=1,
                                                         total_steps=RESUME_STEPS))
    tcfg = trainer_mod.TrainerConfig(total_steps=RESUME_STEPS, checkpoint_every=10 ** 9,
                                     log_every=10 ** 9, seed=SEED, hyper=hyper)
    times = {}

    def run(label, trainer, feed):
        t = time.perf_counter()
        trainer.run(iter(feed))
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t
        return trainer

    torch.use_deterministic_algorithms(True)
    try:
        straight = run("straight", trainer_mod.Trainer(cfg, tcfg, device=DEVICE), batches)
        dev = ZonedDevice(num_zones=RESUME_ZONES, zone_bytes=RESUME_ZONE_BYTES)
        store = train_mod.ZonedCheckpointStore(device=dev, keep=2, torch_device=DEVICE)
        first = run("first_half_and_save", trainer_mod.Trainer(
            cfg, replace(tcfg, total_steps=half), store=store, device=DEVICE), batches)
        check(store.latest_step() == half, f"saved steps {store.steps()}")
        del first
        resumed = run("restore_and_second_half", trainer_mod.Trainer(
            cfg, tcfg, store=store, device=DEVICE), batches)
        equal = {}
        for name in ("params", "m", "v", "step"):
            a, b = tree_mod.leaves(straight.state[name]), tree_mod.leaves(resumed.state[name])
            equal[name] = len(a) == len(b) and all(
                x.device.type == torch.device(DEVICE).type and x.dtype == y.dtype
                and torch.equal(x, y)
                for x, y in zip(a, b))
        check(int(resumed.state["step"]) == RESUME_STEPS, "resumed step")
        check(all(equal.values()), f"resume not bit-exact: {equal}")
        del resumed
        faulty = run("resume_without_replay", trainer_mod.Trainer(
            cfg, tcfg, store=StoreAt(store, half), device=DEVICE), batches[:half] + batches)
        fault_equal = all(torch.equal(x, y) for x, y in zip(
            tree_mod.leaves(straight.state["params"]), tree_mod.leaves(faulty.state["params"])))
        check(not fault_equal, "a resume that does not replay the pipeline matched")
        n_params = sum(x.numel() for x in tree_mod.leaves(straight.state["params"]))
        state_bytes = sum(x.numel() * x.element_size() for x in tree_mod.leaves(straight.state))
        losses = [h["loss"] for h in straight.history]
    finally:
        torch.use_deterministic_algorithms(False)
    out = dict(cut={"num_layers": RESUME_LAYERS}, batch=RESUME_BATCH, seq=TRAIN_SEQ,
               steps=RESUME_STEPS, saved_at=half, parameters=n_params,
               train_state_bytes=state_bytes, zones=RESUME_ZONES, zone_bytes=RESUME_ZONE_BYTES,
               deterministic_algorithms=True, bit_equal=equal, losses=losses,
               planted_no_replay_equal=fault_equal, seconds=times)
    del straight, faulty, store, dev
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(torch, cfgs, models, api, launch, step_mod, opt_mod, trainer_mod, train_mod,
                tree_mod, ZonedDevice, counted, card):
    """The training path on the card: train_main_run, train_grad_check,
    train_grad_check_bf16, train_loss_check, then train_resume_check. No hand-written kernel of the port is on this
    path: each wrapper's count is set to 0 before and read after, and must
    stay 0."""
    t_phase = time.perf_counter()
    for fn in counted:
        fn.launches = 0
    main_run = train_main_run(torch, launch, models, step_mod, opt_mod, tree_mod)
    grads = train_grad_check(torch, cfgs, models, api, step_mod, opt_mod, tree_mod)
    grads_bf16 = train_grad_check_bf16(torch, cfgs, models, api, step_mod, tree_mod)
    loss = train_loss_check(torch, cfgs, models, step_mod, opt_mod)
    resume = train_resume_check(torch, cfgs, ZonedDevice, train_mod, step_mod, opt_mod,
                                trainer_mod, tree_mod)
    launches = {fn.__name__: fn.launches for fn in counted}
    check(not any(launches.values()), f"kernels launched on the train path: {launches}")
    emit("train", card=card, run=main_run, grad_check=grads, grad_check_bf16=grads_bf16,
         loss_check=loss, exact_resume=resume,
         kernel_launches=launches,
         cuts={TRAIN_ARCH + " run": "none (24 layers, published widths)",
               TRAIN_ARCH + " gradient checks": {"num_layers": GRAD_CHECK["num_layers"]},
               TRAIN_ARCH + " loss check": {"num_layers": RESUME_LAYERS},
               TRAIN_ARCH + " exact resume": {"num_layers": RESUME_LAYERS}},
         seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------------------ the mesh

def is_card_dtensor(t):
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor) and t.device.type == "cuda"


def mesh_leaf_check(torch, got, want):
    """Card leaves ``got`` against host leaves ``want``, one leaf on the card
    at a time: bit-identical or not, the largest |got - want|, the worst
    elementwise share of the bound (|d| / (MESH_TOL + MESH_TOL |want|)) and
    the worst relative L2 distance in units of MESH_TOL; the same two
    shares for the largest leaf scaled by 1 + MESH_FAULT (planted)."""
    big = max(range(len(want)), key=lambda i: want[i].numel())
    out = dict(bit_identical=True, max_abs=0.0, elementwise_share=0.0, l2_share=0.0)
    for i, (a, w) in enumerate(zip(got, want)):
        a, b = a.to_local(), w.to(DEVICE)
        out["bit_identical"] &= bool(torch.equal(a, b))
        tried = [(None, a)] + ([("planted", a * (1 + MESH_FAULT))] if i == big else [])
        for label, x in tried:
            xf, bf = x.double(), b.double()
            d = (xf - bf).abs()
            ew = float((d / (MESH_TOL + MESH_TOL * bf.abs())).max()) if d.numel() else 0.0
            nb = float(bf.norm())
            l2 = float(d.norm()) / (MESH_TOL * nb) if nb else float(d.max() > 0)
            if label:
                out["planted_elementwise_share"], out["planted_l2_share"] = ew, l2
            else:
                out["max_abs"] = max(out["max_abs"], float(d.max()) if d.numel() else 0.0)
                out["elementwise_share"] = max(out["elementwise_share"], ew)
                out["l2_share"] = max(out["l2_share"], l2)
    return out


def mesh_train(torch, cfgs, api, step_mod, opt_mod, trainer_mod, tree_mod, rules_mod, mesh):
    """TRAIN_ARCH at its published widths and depth, bf16, the train phase's
    4 x 4,096 tokens in 2 micro-batches: one step of the unsharded Trainer
    (its state then copied to the host and the trainer freed), then
    MESH_TRAIN_STEPS of Trainer(mesh=, state_shardings=param_shardings(...))
    under use_rules(rules_for("train")), the second under the profiler.
    Every leaf handed to the sharded step must be a DTensor on the card."""
    cfg = cfgs.get_config(TRAIN_ARCH)
    hyper = step_mod.TrainHyper(grad_accum=TRAIN_ACCUM, adamw=opt_mod.AdamWHyper(
        lr=TRAIN_LR, warmup_steps=1, total_steps=100))
    batch = api.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=DEVICE)

    def trainer(steps, **kw):
        tcfg = trainer_mod.TrainerConfig(total_steps=steps, checkpoint_every=10**9,
                                         log_every=10**9, seed=SEED, hyper=hyper)
        return trainer_mod.Trainer(cfg, tcfg, device=DEVICE, **kw)

    def event_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = trainer(1)
    inner, plain_ms = plain.step_fn, []

    def plain_step(state, b):
        out, ms = event_ms(lambda: inner(state, b))
        plain_ms.append(ms)
        return out
    plain.step_fn = plain_step
    plain.run([batch])
    plain_peak = torch.cuda.max_memory_allocated()
    plain_loss = plain.history[0]["loss"]
    t = time.perf_counter()
    want = [x.cpu() for x in tree_mod.leaves(plain.state)]
    to_host_s = time.perf_counter() - t
    del plain, inner
    gc.collect()
    torch.cuda.empty_cache()

    rules = rules_mod.rules_for("train", cfg, mesh)
    shardings = rules_mod.param_shardings(step_mod.train_state_specs(cfg), mesh, rules)
    torch.cuda.reset_peak_memory_stats()
    sharded = trainer(MESH_TRAIN_STEPS, mesh=mesh, state_shardings=shardings)
    inner, rec = sharded.step_fn, {"ms": [], "handed": []}

    def sharded_step(state, b):
        rec["handed"].append(all(map(is_card_dtensor, tree_mod.leaves(state)))
                             and all(map(is_card_dtensor, b.values())))
        if rec["ms"]:                     # the second step, under the profiler
            box = []
            dev_ms, kernels, launches = profiled_ms(
                torch, lambda: box.append(event_ms(lambda: inner(state, b))), reps=1,
                warmup=0)
            out, ms = box[0]
            rec["profile"] = dict(step_device_ms=dev_ms, step_launches=launches,
                                  step_idle_share=None if dev_ms is None else 1 - dev_ms / ms,
                                  top_kernels_ms=dict(sorted(kernels.items(),
                                                             key=lambda kv: -kv[1])[:6]))
        else:
            out, ms = event_ms(lambda: inner(state, b))
            t = time.perf_counter()
            rec["leaves"] = mesh_leaf_check(torch, tree_mod.leaves(out[0]), want)
            rec["leaves"]["seconds"] = time.perf_counter() - t
        rec["ms"].append(ms)
        return out
    sharded.step_fn = sharded_step
    with rules_mod.use_rules(rules):
        sharded.run([batch] * MESH_TRAIN_STEPS)
    sharded_peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in sharded.history]
    leaves = rec["leaves"]
    check(len(losses) == MESH_TRAIN_STEPS and all(rec["handed"]),
          f"sharded steps {len(losses)}; every leaf a card DTensor: {rec['handed']}")
    check(abs(losses[0] - plain_loss) <= MESH_LOSS_RTOL * abs(plain_loss),
          f"sharded loss {losses[0]} against {plain_loss}")
    check(leaves["elementwise_share"] <= 1 and leaves["l2_share"] <= 1,
          f"a sharded leaf off the unsharded one: {leaves}")
    check(leaves["planted_l2_share"] > 1, f"a leaf scaled by {1 + MESH_FAULT} passed: {leaves}")
    out = dict(steps=MESH_TRAIN_STEPS, unsharded_step_ms=plain_ms[0],
               sharded_step_ms=rec["ms"], sharded_over_unsharded=rec["ms"][-1] / plain_ms[0],
               loss_unsharded=plain_loss, losses_sharded=losses,
               loss_bit_identical=losses[0] == plain_loss, leaves=leaves,
               unsharded_state_to_host_seconds=to_host_s,
               max_memory_allocated=dict(unsharded=plain_peak, sharded=sharded_peak),
               profile=rec["profile"], every_leaf_a_card_dtensor=all(rec["handed"]))
    del sharded, inner, want, batch, rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_serve(torch, cfgs, models, api, serve_mod, tree_mod, rules_mod, attn_mod, mesh):
    """MODEL_ARCH at its published widths and depth, bf16: ServeModel's
    greedy generate of 1 + MESH_NEW tokens (the model phase's prompts),
    then, from the same prompts' prefill, MESH_NEW decode steps of
    make_serve_step twice: on plain tensors, and over DTensor params and a
    DTensor cache under use_rules(rules_for("decode")). Held: the sharded
    tokens equal generate's, its logits within MODEL_LOGIT_LIMIT of
    generate's, and the K/V it wrote within MODEL_LOGIT_LIMIT of the plain
    steps'. Planted: the first sharded step again with the cache write
    skipped, whose slot must fail that check."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cfg = cfgs.get_config(MODEL_ARCH)
    B, L, N = MODEL_BATCH, MODEL_PROMPT, MESH_NEW + 1
    model = serve_mod.ServeModel(cfg, models.init_params(models.param_specs(cfg), SEED, DEVICE),
                                 device=DEVICE)
    batch = api.make_batch(cfg, B, L, seed=SEED, device=DEVICE)
    want_tokens, want_logits = model.generate(batch, N)
    with torch.no_grad():
        last, prefix = model.prefill(batch)
    cache = models.init_params(models.cache_specs(cfg, B, L + N), 0, DEVICE)
    tree_mod.tree_map(serve_mod._fit, prefix, cache)
    del prefix
    plain_cache, spare = (tree_mod.tree_map(torch.clone, cache) for _ in range(2))
    rules = rules_mod.rules_for("decode", cfg, mesh)
    params = rules_mod.distribute_tree(
        model.tree(), rules_mod.param_shardings(models.param_specs(cfg), mesh, rules))
    c_sh = rules_mod.param_shardings(models.cache_specs(cfg, B, L + N), mesh, rules)
    cache, spare = rules_mod.distribute_tree(cache, c_sh), rules_mod.distribute_tree(spare, c_sh)
    lay = [Shard(0) if n == "data" else Replicate() for n in mesh.mesh_dim_names]
    step = serve_mod.make_serve_step(cfg)
    first = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    check(torch.equal(first, want_tokens[:, :1]), "the prefill's token differs from generate's")

    def decode(p, c, sharded):
        """MESH_NEW greedy steps: (tokens, logits, device ms, host ms, every
        leaf handed in a card DTensor)."""
        tok, toks, logits, ms, host_ms, handed = first, [], [], [], [], []
        for i in range(MESH_NEW):
            t_in = distribute_tensor(tok, mesh, lay, src_data_rank=None) if sharded else tok
            handed.append(all(map(is_card_dtensor, tree_mod.leaves(p) + tree_mod.leaves(c)))
                          and is_card_dtensor(t_in))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            nxt, lg, c = step(p, c, t_in, L + i)
            end.record()
            host_ms.append((time.perf_counter() - t) * 1e3)
            end.synchronize()
            ms.append(start.elapsed_time(end))
            tok = nxt.full_tensor() if sharded else nxt
            toks.append(tok)
            logits.append(lg.full_tensor() if sharded else lg)
        return torch.cat(toks, dim=1), torch.stack(logits, dim=1), ms, host_ms, all(handed)

    def written(c, slots):
        """max |K/V - the plain steps' K/V| at ``slots`` over the cache."""
        return max(float((a.to_local() - b)[:, :, slots].float().abs().max())
                   for a, b in zip(tree_mod.leaves(c), tree_mod.leaves(plain_cache)))
    with torch.no_grad():
        plain_tokens, _, plain_ms, plain_host_ms, _ = decode(model.tree(), plain_cache, False)
        with rules_mod.use_rules(rules):
            got_tokens, got_logits, ms, host_ms, handed = decode(params, cache, True)
            # planted: the first step again, from the prefill's cache, writing nothing
            write = attn_mod.write_slot
            attn_mod.write_slot = lambda *a: None
            try:
                step(params, spare, distribute_tensor(first, mesh, lay, src_data_rank=None), L)
            finally:
                attn_mod.write_slot = write
    err, share, finite = logit_check(torch, got_logits, want_logits[:, 1:])
    kv_err, bad_kv_err = written(cache, slice(L, L + MESH_NEW)), written(spare, L)
    check(handed, "a leaf handed to the sharded decode is not a DTensor on the card")
    check(torch.equal(plain_tokens, want_tokens[:, 1:]), "plain decode tokens differ from generate's")
    check(finite and torch.equal(got_tokens, want_tokens[:, 1:]),
          "sharded decode tokens differ from generate's")
    check(share <= 1, f"sharded decode logits {err} off generate's (limit {MODEL_LOGIT_LIMIT})")
    check(kv_err <= MODEL_LOGIT_LIMIT, f"sharded K/V writes {kv_err} off the plain steps'")
    check(bad_kv_err > MODEL_LOGIT_LIMIT, f"a decode without its cache write passed ({bad_kv_err})")
    out = dict(steps=MESH_NEW, batch=B, prompt=L, tokens_equal=True,
               logits_bit_identical=bool(torch.equal(got_logits, want_logits[:, 1:])),
               logits_max_abs=err, logits_share_of_limit=share, kv_written_max_abs=kv_err,
               planted_skipped_write_kv_max_abs=bad_kv_err,
               unsharded_step_ms=dict(median=statistics.median(plain_ms[1:]), all=plain_ms),
               unsharded_step_host_ms=statistics.median(plain_host_ms[1:]),
               sharded_step_ms=dict(median=statistics.median(ms[1:]), first=ms[0], all=ms),
               sharded_step_host_ms=dict(median=statistics.median(host_ms[1:]),
                                         first=host_ms[0]),
               every_leaf_a_card_dtensor=handed)
    del model, params, cache, spare, plain_cache, batch, want_logits, got_logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_restore(torch, cfgs, ZonedDevice, train_mod, tree_mod, rules_mod, mesh):
    """The checkpoint phase's granite-8b layer state (same generator), saved
    to zones and restored with ``shardings=`` onto the card mesh: every
    leaf a DTensor on the mesh, its local shard equal bit for bit to the
    saved leaf."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    state = granite_layer_state(torch, g)
    rules = rules_mod.rules_for("train", cfgs.get_config(MODEL_ARCH), mesh)

    def sharding(axes, t):
        return rules_mod.named_sharding_for(t.shape, axes, mesh, rules)
    sh = {k: {g_: {n: sharding(LAYER_AXES[g_][n], t) for n, t in grp.items()}
              for g_, grp in state[k].items()} for k in ("params", "m", "v")}
    sh["step"] = sharding((), state["step"])
    dev = ZonedDevice(num_zones=CKPT_ZONES, zone_bytes=CKPT_ZONE_BYTES)
    store = train_mod.ZonedCheckpointStore(device=dev, keep=2, torch_device=DEVICE)
    t = time.perf_counter()
    store.save(1, state)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    got = store.restore(like=state, shardings=sh)
    restore_s = time.perf_counter() - t
    pairs = list(zip(tree_mod.leaves(got), tree_mod.leaves(state)))
    check(all(is_card_dtensor(a) and tuple(a.device_mesh.shape) == tuple(mesh.shape)
              for a, _ in pairs), "a restored leaf is not a DTensor on the card mesh")
    same = all(torch.equal(a.to_local(), b) for a, b in pairs)
    check(same, "a restored shard differs from the saved leaf")
    out = dict(leaves=len(pairs), payload_bytes=sum(b.numel() * b.element_size() for _, b in pairs),
               save_seconds=save_s, restore_seconds=restore_s, bit_identical=same,
               host_to_card_bytes=store.h2d.snapshot()[1])
    del got, state, store, dev, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_pipeline(torch, pipe_mod):
    """pipeline_apply on a ("pipe",) mesh of 1 on the card against the
    stages applied in turn."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    M, mb, d = MESH_PIPE["n_micro"], MESH_PIPE["micro_batch"], MESH_PIPE["width"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = {"w": torch.randn((1, d, d), generator=g, device=DEVICE) * d ** -0.5,
              "b": torch.randn((1, d), generator=g, device=DEVICE) * 0.1}
    xs = torch.randn((M, mb, d), generator=g, device=DEVICE)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    got = pipe_mod.pipeline_apply(stage, params, xs, mesh=mesh)
    want = torch.stack([stage({k: v[0] for k, v in params.items()}, x) for x in xs])
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"the one-stage pipeline is {err} off the stages applied in turn")
    return dict(stages=1, n_micro=M, micro_batch=mb, width=d, max_abs=err)


def phase_mesh(torch, cfgs, models, api, serve_mod, step_mod, opt_mod, trainer_mod, train_mod,
               tree_mod, ZonedDevice, counted, card):
    """The device mesh on the card: a world-size-1 NCCL group and a 1 x 1
    ("data", "model") mesh from make_local_mesh, then mesh_train,
    mesh_serve, mesh_restore and mesh_pipeline. No collective crosses
    between cards (one card): this holds DeviceMesh on CUDA, DTensor's
    dispatch of every op of the model, train and serve paths, and the
    sharded restore, and measures DTensor's host cost. No kernel of the
    port is on this path (the counts must stay 0)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as attn_mod
    from repro_torch.sharding import pipeline as pipe_mod
    from repro_torch.sharding import rules as rules_mod
    t_phase = time.perf_counter()
    for fn in counted:
        fn.launches = 0
    t = time.perf_counter()
    mesh = make_local_mesh(1, 1, device=DEVICE)
    group = dict(backend=dist.get_backend(), world_size=dist.get_world_size(),
                 mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                 seconds=time.perf_counter() - t)
    check(group["backend"] == "nccl" and mesh.device_type == "cuda",
          f"the mesh's group is {group['backend']} on {mesh.device_type}")
    try:
        train = mesh_train(torch, cfgs, api, step_mod, opt_mod, trainer_mod, tree_mod,
                           rules_mod, mesh)
        serve = mesh_serve(torch, cfgs, models, api, serve_mod, tree_mod, rules_mod,
                           attn_mod, mesh)
        restore = mesh_restore(torch, cfgs, ZonedDevice, train_mod, tree_mod, rules_mod, mesh)
        pipeline = mesh_pipeline(torch, pipe_mod)
    finally:
        dist.destroy_process_group()
    launches = {fn.__name__: fn.launches for fn in counted}
    check(not any(launches.values()), f"kernels launched on the mesh path: {launches}")
    emit("mesh", card=card, group=group, train=train, serve=serve, restore=restore,
         pipeline=pipeline, kernel_launches=launches,
         note="world size 1: no collective bandwidth is measured",
         cuts={TRAIN_ARCH + " train": "none (24 layers, published widths)",
               MODEL_ARCH + " serve": "none (36 layers, published widths)",
               MODEL_ARCH + " restore": "one layer's train state, as the checkpoint phase"},
         seconds=time.perf_counter() - t_phase)


def profiled_ms(torch, fn, reps=10, warmup=3, tries=1):
    """(device ms per call, {kernel name: its device ms per call}, device
    launches per call) from torch.profiler: the summed device time of what
    one call runs on the card; (None, {}, None) when the profiler records
    no device time. ``warmup`` calls run first, in a step the profiler
    records and drops; with ``warmup=0`` the profiler keeps every call (a
    train step that must run once). The profiler can miss kernels: a
    session's first ones without the warm-up step, and late in a process
    even with it (which made earlier runs see 1.3 of a paged call's 2
    launches; so the timing phase runs right after the build), and now and
    then a whole session (on an H100, once in the first half minute of a
    process), or the same few kernels of three sessions in a row (7 of 10
    calls of one row, on an H100). A miss only lowers the count, so of
    ``tries`` sessions the one that saw the most kernels is kept."""
    from torch.profiler import ProfilerActivity, profile, schedule
    best = (None, {}, None)
    for _ in range(tries):
        torch.cuda.synchronize()
        steps = (warmup, reps) if warmup else (reps,)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1) if warmup
                     else None) as prof:
            for n in steps:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                if warmup:
                    prof.step()
        total_us, names, count = 0.0, {}, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                total_us += us
                names[e.key[:60]] = us / reps / 1e3
                count += e.count
        if total_us and (best[2] is None or count / reps > best[2]):
            best = (total_us / reps / 1e3, names, count / reps)
    return best


def host_us(torch, fn, reps=50, batches=5):
    """Host time to enqueue one call (no synchronisation inside), µs, as
    (the median of ``batches`` means of ``reps`` calls, so that one stall
    of the machine's shared host does not set it; the mean of all the
    calls, as one batch's mean is)."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        means.append((t1 - t0) / reps * 1e6)
    return statistics.median(means), statistics.fmean(means)


def measure(torch, fn, reps=20):
    ms, (host, host_mean) = cuda_ms(torch, fn, reps=reps), host_us(torch, fn)
    dev_ms, names, per_call = profiled_ms(torch, fn, tries=6)
    return dict(ms=ms, device_ms=dev_ms, host_us=host, host_us_mean=host_mean,
                device_kernels=names, device_launches_per_call=per_call)


def clocks():
    q = "clocks.sm,clocks.mem,clocks.max.sm,clocks.max.mem,power.draw,temperature.gpu"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def paged_timing(torch, pa_kernel, pa_ref, build):
    """The paged_attention row at granite-8b width: B=64, H/KV/hd =
    32/8/128, bf16, a 4,096 x 128-token pool, MZ=64, every sequence 4,096
    tokens long in 32 distinct zones, then -1. The library yardstick is one
    scaled_dot_product_attention call (enable_gqa, boolean mask) over a
    cache gathered beforehand into a contiguous [B, KV, S, hd]; the SDPA
    call is timed alone and the gather beside it. Beside the times: the
    plan (kernel.py::plan) and the registers and spills ptxas gave the
    paged_partial instance this shape runs (``build``: phase_build's
    report)."""
    import torch.nn.functional as F
    B, H, KV, hd = 64, GRANITE_HEADS, GRANITE["kv_heads"], GRANITE["head_dim"]
    NZ, ZL, MZ = GRANITE["num_zones"], GRANITE["zone_len"], GRANITE["max_zones_per_seq"]
    length = 4096
    used = length // ZL
    g = torch.Generator(device=DEVICE).manual_seed(7)
    k = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=torch.bfloat16)
    v = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn(B, H, hd, generator=g, device=DEVICE, dtype=torch.bfloat16)
    tab = torch.full((B, MZ), -1, dtype=torch.int32, device=DEVICE)
    tab[:, :used] = torch.randperm(NZ, generator=g, device=DEVICE)[:B * used].reshape(
        B, used).int()
    lengths = torch.full((B,), length, dtype=torch.int32, device=DEVICE)
    pos = torch.arange(MZ * ZL, device=DEVICE)[None, :]
    valid = (pos < lengths[:, None]) & (tab >= 0).repeat_interleave(ZL, dim=1)
    n_tok = int(valid.sum())                       # positions this run's data needs
    n_bytes = (2 * n_tok * KV * hd * k.element_size() + 2 * q.numel() * q.element_size()
               + tab.numel() * 4 + lengths.numel() * 4)
    n_ops = 4 * n_tok * H * hd                     # q.k and p.v over every query head

    def kernel():
        return pa_kernel.paged_attention_kernel(q, k, v, tab, lengths)

    def plain():
        return pa_ref.paged_attention_ref(q, k, v, tab, lengths)

    cols = -(-int(lengths.max()) // ZL)

    def gather():
        idx = tab[:, :cols].long().clamp(min=0)
        return tuple(x[idx].reshape(B, cols * ZL, KV, hd).transpose(1, 2).contiguous()
                     for x in (k, v))
    kc, vc = gather()
    mask = valid[:, None, None, :cols * ZL]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True)
    out = kernel()
    try:
        lib_out = library()[:, :, 0, :]
        lib, lib_err = measure(torch, library), None
        lib_vs_kernel = float((lib_out.float() - out.float()).abs().max())
    except (TypeError, RuntimeError) as e:   # an SDPA without enable_gqa
        lib, lib_err, lib_vs_kernel = None, str(e)[:200], None
    k_t, p_t = measure(torch, kernel), measure(torch, plain, reps=5)
    gather_ms = cuda_ms(torch, gather, reps=5)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    plan = pa_kernel.plan(B, H, KV, hd, MZ, ZL, k.element_size(),
                          torch.cuda.get_device_properties(0).multi_processor_count)
    held = (tab >= 0).nonzero().tolist()            # (sequence, zone) of every valid zone
    used_splits = len({(b, z // plan.zones_per_split) for b, z in held})
    # the instance csrc/paged_attn.cu::launch_upl picks: units of hd a lane
    # holds in the logits, tensor cores for bf16 with 16-token stages
    units = hd * k.element_size() // 16
    upl = 1
    while upl * 8 < units:
        upl *= 2
    mma = int(plan.stage_tokens == 16 and hd % 16 == 0)
    key = f"13paged_partialI13__nv_bfloat16Li{upl}ELb{mma}"
    paged = build["paged_attn"]
    partial = dict(registers=paged["registers_by_kernel"].get(key),
                   spill_store_bytes=paged["spill_store_bytes"].get(key, 0), ptxas_name=key)
    row = dict(ms=k_t["ms"], device_ms=k_t["device_ms"], host_us=k_t["host_us"],
               host_us_mean=k_t["host_us_mean"], device_kernels=k_t["device_kernels"],
               device_launches_per_call=k_t["device_launches_per_call"],
               plain_ms=p_t["ms"], plain_device_ms=p_t["device_ms"],
               library_ms=lib["ms"] if lib else None,
               library_device_ms=lib["device_ms"] if lib else None,
               library_kernels=lib["device_kernels"] if lib else None,
               library_error=lib_err, library_vs_kernel_max_abs=lib_vs_kernel,
               library_gather_ms=gather_ms,
               bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
               share_of_bound=b_ms / k_t["ms"], bytes=n_bytes, operations=n_ops,
               achieved_tb_per_s=n_bytes / k_t["ms"] / 1e9,
               shape=dict(B=B, H=H, KV=KV, hd=hd, NZ=NZ, ZL=ZL, MZ=MZ, length=length),
               splits=plan.splits, zones_per_split=plan.zones_per_split, ctas=plan.ctas,
               ctas_reading_tokens=used_splits * plan.ctas // (B * plan.splits),
               dynamic_smem_bytes=plan.smem, stage_tokens=plan.stage_tokens,
               stages=plan.stages, kv_heads_a_cta=plan.kv_chunk, paged_partial=partial)
    del k, v, kc, vc
    torch.cuda.empty_cache()
    return row


def phase_timing(torch, tp, zf_kernel, zf_ops, zf_ref, data, pa_kernel, pa_ref, build):
    """Times at the main path's shape, on a zone already on the card. ``ms``
    is CUDA events around 20 back-to-back calls; ``device_ms`` what the
    profiler saw on the card per call; ``host_us`` the enqueue cost (the
    median of 5 batches of 50 calls; ``host_us_mean`` the mean of all
    250)."""
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    ops, imms = zf_ops.encode_program(program, DEVICE)
    host = torch.from_numpy(data).pin_memory()
    x = torch.empty_like(host, device=DEVICE)
    h2d = cuda_ms(torch, lambda: x.copy_(host, non_blocking=True), reps=10)
    x = x.reshape(-1, 1024)
    thr = RAND_MAX // 2
    transform = zf_ref.decode_transform(ops, imms)

    def single(pages):
        return (lambda: zf_kernel.filtered_reduce(pages, kind="count", ops=ops, imms=imms),
                lambda: zf_ref.filtered_reduce_ref(pages, "count", transform),
                lambda: (pages > thr).sum(), pages)

    def batched(pages):
        return (lambda: zf_kernel.filtered_reduce_batched(pages, kind="count", ops=ops,
                                                          imms=imms),
                lambda: zf_ref.filtered_reduce_batched_ref(pages, "count", transform),
                lambda: (pages > thr).sum(dim=(1, 2)), pages)
    # the kernels line's rows at their main paths' shapes: the 256 MiB zone
    # of NvmCsd, and one array dispatch (512 chunks x 64 pages, 128 MiB);
    # beside them the 8-chunk shape of earlier runs and one 256 KiB chunk
    # (an array chunk re-served alone)
    chunks, pages = BATCH_SHAPES[1]
    rows = {
        "filtered_reduce": single(x),
        "filtered_reduce_batched": batched(x[:chunks * pages].reshape(chunks, pages, 1024)),
        "filtered_reduce_batched_8x8192": batched(x.reshape(8, -1, 1024)),
        "filtered_reduce_256KiB_chunk": single(x[:ARRAY_STRIPE]),
    }
    out = {}
    for name, (kernel, plain, library, pages) in rows.items():
        k, p, lib = measure(torch, kernel), measure(torch, plain, reps=5), measure(torch, library)
        n_out = pages.shape[0] if pages.dim() == 3 else 1
        n_bytes = pages.numel() * pages.element_size() + 4 * n_out
        b_ms, b_by = bound_ms(n_bytes, 2 * pages.numel())   # a compare and an add each
        out[name] = dict(ms=k["ms"], device_ms=k["device_ms"], host_us=k["host_us"],
                         host_us_mean=k["host_us_mean"], device_kernels=k["device_kernels"],
                         device_launches_per_call=k["device_launches_per_call"],
                         plain_ms=p["ms"], plain_device_ms=p["device_ms"],
                         library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                         bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
                         share_of_bound=b_ms / k["ms"], shape=list(pages.shape))
    copy_ms = measure(torch, lambda: x.clone())            # a plain 256 MiB read+write
    out["paged_attention"] = paged_timing(torch, pa_kernel, pa_ref, build)
    emit("timing", shape=list(data.reshape(-1, 1024).shape), h2d_event_ms=h2d,
         h2d_gb_per_s=data.nbytes / h2d / 1e6, clone_256MiB=copy_ms,
         clocks_after=clocks(), **out)
    seen = {name: row["device_launches_per_call"] for name, row in out.items()}
    check(all(n == (2 if name == "paged_attention" else 1) for name, n in seen.items()),
          f"device launches a call {seen}: one a zone-filter call, two a paged call")
    return out


def main():
    # cuBLAS reads its workspace setting when its first handle is made; the
    # train phase's deterministic check needs ":4096:8" (on sm_90 the same
    # 32 MiB PyTorch chooses by default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.array as array_mod
    import repro_torch.data as data_mod
    import repro_torch.faults.crash as crash_mod
    import repro_torch.train as train_mod
    from repro_torch.core import NvmCsd
    from repro_torch.core import csd as csd_mod
    from repro_torch.core import programs as tp
    from repro_torch.kernels import _build
    from repro_torch.kernels.zone_filter import kernel as zf_kernel
    from repro_torch.kernels.zone_filter import ops as zf_ops
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ref as pa_ref
    from repro_torch.kernels.zone_filter import ref as zf_ref
    from repro_torch.serve import KVZonePool
    from repro_torch.telemetry import trace
    from repro_torch import _tree as tree_mod
    from repro_torch.zns import ZonedDevice
    import repro_torch.configs as cfgs
    import repro_torch.models as models
    import repro_torch.models.api as api
    import repro_torch.serve.step as serve_mod
    import repro_torch.launch.train as launch
    import repro_torch.train.optimizer as opt_mod
    import repro_torch.train.step as step_mod
    import repro_torch.train.trainer as trainer_mod

    t_start = time.perf_counter()
    try:
        name, smi_line = phase_device(torch)
        build = phase_build([zf_kernel, pa_kernel], _build)
        zone = np.random.default_rng(0).integers(0, RAND_MAX, ZONE_BYTES // 4, dtype=np.int32)
        times = phase_timing(torch, tp, zf_kernel, zf_ops, zf_ref, zone, pa_kernel, pa_ref,
                             build)       # the Figure 2 zone, as phase_offload draws it
        del zone
        errs = phase_kernels(torch, tp, zf_kernel, zf_ops, zf_ref, pa_kernel, pa_ref)
        data, launches, csd_count = phase_offload(torch, tp, NvmCsd, ZonedDevice, csd_mod,
                                                  zf_kernel)
        on_array = phase_array(torch, tp, ZonedDevice, array_mod, csd_mod, trace, zf_kernel,
                               data, csd_count)
        launches["filtered_reduce_batched"] = phase_batched(torch, tp, zf_kernel, zf_ops, data)
        for kname, n in on_array.items():
            launches[kname] += n
        launches["paged_attention"] = phase_serve(torch, KVZonePool, pa_kernel, pa_ref)
        phase_pipeline(torch, ZonedDevice, array_mod, csd_mod, data_mod, zf_kernel, trace,
                       smi_line)
        phase_checkpoint(torch, ZonedDevice, train_mod, tree_mod, crash_mod, smi_line)
        counted = (zf_kernel.filtered_reduce, zf_kernel.filtered_reduce_batched,
                   pa_kernel.paged_attention_kernel)
        phase_model(torch, cfgs, models, api, serve_mod, tree_mod, counted, smi_line)
        phase_train(torch, cfgs, models, api, launch, step_mod, opt_mod, trainer_mod, train_mod,
                    tree_mod, ZonedDevice, counted, smi_line)
        phase_mesh(torch, cfgs, models, api, serve_mod, step_mod, opt_mod, trainer_mod,
                   train_mod, tree_mod, ZonedDevice, counted, smi_line)
        del data
    except PhaseFailed as e:
        emit("failed", error=str(e))
        return 1
    zf_source = "src/repro_torch/kernels/zone_filter/csrc/zone_filter.cu"
    table = []
    for kname, source, replaces in (
            ("filtered_reduce", zf_source, "src/repro/kernels/zone_filter/kernel.py:75"),
            ("filtered_reduce_batched", zf_source,
             "src/repro/kernels/zone_filter/kernel.py:147"),
            ("paged_attention", "src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
             "src/repro/kernels/paged_attn/kernel.py:73")):
        t = times[kname]
        table.append({"name": kname, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[kname],
                      "max_abs_err": errs[kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                      "library_ms": t["library_ms"]})
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi_line)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
