#!/usr/bin/env python3
"""Timed variants of the paged-attention kernel: where its time goes.

    python3 tools/paged_attn_variants.py [--tree DIR] [--variants base,no_math,one_zone]

Nsight Compute does not run on every card's host, so this script reads the
kernel's stalls by timing variants of its source, one change each:

  base      the source as it is
  no_math   the K/V reads kept, the attention arithmetic removed (what the
            reads alone cost: the memory side)
  one_zone  every split of a sequence reads the sequence's first zone over
            and over, so K/V come from L2 (what the arithmetic costs when
            the reads are cheap: the instruction side)
  unpadded  (the staged kernel) each run of slots one bulk copy into
            unpadded rows, instead of one copy a token into rows padded by
            16 bytes; unpadded_no_math: the same without the arithmetic

Each variant is a text substitution on ``csrc/paged_attn.cu`` of the tree
given by ``--tree`` (a checkout of the repository; default: this one),
built by that tree's ``_build`` into its ``build/`` and launched through that
tree's wrapper, so one script reads both an older kernel and a newer one.
Shapes: the ``timing`` line's granite-8b row of ``chip_smoke.py`` (B=64,
H/KV/hd 32/8/128, bf16, 4,096 tokens a sequence in 32 of 64 zones) and the
two decode-wave tables of its ``serve`` phase (32 sequences of 2,056
tokens; 16 of 2,064 and 16 of 1,032). Times are CUDA events over 20 calls
after 3 warm-up calls; device ms per kernel from ``torch.profiler``. One
JSON line a (variant, shape) on stdout. Needs one CUDA card.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 700 W (NVIDIA data sheet)

# variant -> alternatives; an alternative is a list of (old, new) text
# substitutions, each of which must match exactly once. The first
# alternative that matches the source is applied.
_SINK = """\
__device__ __forceinline__ void sink(const Raw<float>& r, float& a) {
  a += r.a.x + r.a.y + r.a.z + r.a.w + r.b.x + r.b.y + r.b.z + r.b.w;
}
__device__ __forceinline__ void sink(const Raw<__nv_bfloat16>& r, float& a) {
  a += __uint_as_float((r.a.x ^ r.a.y ^ r.a.z ^ r.a.w) & 0x3f7fffffu);
}

// GP: registers for up to GP"""
_UNPADDED_ROWS = ("p.srow = p.row_bytes + 16;", "p.srow = p.row_bytes;")
_RUN_COPIES = (
    """        for (int i = lane; i < n; i += 32) {
          bulk_copy(dk + i * p.srow, kbase + off + i * slot_bytes, p.row_bytes, &full[r]);
          bulk_copy(dk + (p.tt + i) * p.srow, vbase + off + i * slot_bytes, p.row_bytes, &full[r]);
        }""",
    """        if (lane == 0 && p.kvc == p.KV) {
          bulk_copy(dk, kbase + off, n * p.row_bytes, &full[r]);
          bulk_copy(dk + p.tt * p.srow, vbase + off, n * p.row_bytes, &full[r]);
        }
        for (int i = lane; p.kvc != p.KV && i < n; i += 32) {
          bulk_copy(dk + i * p.srow, kbase + off + i * slot_bytes, p.row_bytes, &full[r]);
          bulk_copy(dk + (p.tt + i) * p.srow, vbase + off + i * slot_bytes, p.row_bytes, &full[r]);
        }""")
VARIANTS = {
    "base": [[]],
    "no_math": [
        # split-K kernel of PRs 15-19: lane loads summed into one register
        [("// GP: registers for up to GP", _SINK),
         ("      online_step<T, GP>(k0, v0, qv, m, l, acc, ng, uniform, lanes, gmask);\n"
          "      if (two) online_step<T, GP>(k1, v1, qv, m, l, acc, ng, uniform, lanes, gmask);",
          "      sink(k0, acc[0][0]); sink(v0, acc[0][1]);\n"
          "      if (two) { sink(k1, acc[0][2]); sink(v1, acc[0][3]); }")],
        # the staged kernel: consumers wait for each stage and release it
        [("constexpr bool kMath = true;", "constexpr bool kMath = false;")],
    ],
    "one_zone": [[("int zone = row[z];", "int zone = row[0];")]],
    # the staged kernel with K/V rows unpadded, a run of slots one copy
    "unpadded": [[_UNPADDED_ROWS, _RUN_COPIES]],
    "unpadded_no_math": [[_UNPADDED_ROWS, _RUN_COPIES,
                          ("constexpr bool kMath = true;", "constexpr bool kMath = false;")]],
}


def variant_source(src: str, name: str) -> str:
    for alt in VARIANTS[name]:
        if all(src.count(old) == 1 for old, _ in alt):
            for old, new in alt:
                src = src.replace(old, new)
            return src
    raise SystemExit(f"variant {name!r} does not apply to this source")


def serve_tables(torch, g, NZ, MZ, ZL):
    """The serve phase's two decode-wave tables, random distinct zones."""
    out = {}
    for name, lens in (("serve_wave1", [2048 + 8] * 32),
                       ("serve_wave2", [2048 + 16] * 16 + [1024 + 8] * 16)):
        B = len(lens)
        perm = torch.randperm(NZ, generator=g, device="cuda")
        tab = torch.full((B, MZ), -1, dtype=torch.int32, device="cuda")
        i = 0
        for b, n in enumerate(lens):
            nz = -(-n // ZL)
            tab[b, :nz] = perm[i:i + nz].int()
            i += nz
        out[name] = (tab, torch.tensor(lens, dtype=torch.int32, device="cuda"))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--variants", default="base,no_math,one_zone")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_attn_variants: needs a CUDA card", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from torch.profiler import ProfilerActivity, profile

    base_src = pa_kernel.SOURCE.read_text()
    B, H, KV, hd, NZ, ZL, MZ, length = 64, 32, 8, 128, 4096, 128, 64, 4096
    g = torch.Generator(device="cuda").manual_seed(7)
    k = torch.randn(NZ, ZL, KV, hd, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(NZ, ZL, KV, hd, generator=g, device="cuda", dtype=torch.bfloat16)
    used = length // ZL
    tab = torch.full((B, MZ), -1, dtype=torch.int32, device="cuda")
    tab[:, :used] = torch.randperm(NZ, generator=g, device="cuda")[:B * used].reshape(
        B, used).int()
    shapes = {"timing": (tab, torch.full((B,), length, dtype=torch.int32, device="cuda"))}
    shapes.update(serve_tables(torch, g, NZ, MZ, ZL))
    qs = {name: torch.randn(t.shape[0], H, hd, generator=g, device="cuda",
                            dtype=torch.bfloat16) for name, (t, _) in shapes.items()}
    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()

    for name in args.variants.split(","):
        src = variant_source(base_src, name)
        path = tree / "build" / "paged_attn_variants" / f"paged_attn_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        pa_kernel.SOURCE = path
        pa_kernel.load.cache_clear()
        pa_kernel.load()
        for shape, (tab_s, lens_s) in shapes.items():
            q = qs[shape]

            def call():
                return pa_kernel.paged_attention_kernel(q, k, v, tab_s, lens_s)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 20
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            dev = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0.0)
                if us > 0:
                    dev[e.key[:60]] = us / 10 / 1e3
            n_tok = int(lens_s.clamp(min=0).sum())
            n_bytes = 2 * n_tok * KV * hd * 2 + 2 * q.numel() * 2
            row = dict(tree=args.label or str(tree), variant=name, shape=shape, ms=ms,
                       device_ms=dev, bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                       tb_per_s=n_bytes / ms / 1e9, B=int(tab_s.shape[0]), tokens=n_tok,
                       card=smi)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
