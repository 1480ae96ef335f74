"""Plain float32 reference of the ``kvzone`` kind: granite's decoder, in
PyTorch alone, over every session's prompt and teacher-forced tokens.

It imports NumPy and PyTorch alone and reads the widths from the
configuration, the weights and the schedule from the data (the traffic:
which session is on which row at which step, with which tokens), never the
program's zones or results. Every product runs in float32 with TF32 off.

For the sessions the schedule marks checked (``check_share`` of them), it
runs each prompt and its sessions' tokens layer by layer as one block, one
layer's weights upcast at a time: a prompt token sees the prompt's tokens
up to itself, a session's token the whole prompt and its own session's
tokens up to itself. So every step a session ran, warm-up included, is the
row's causal forward pass over prompt plus tokens. A row's answer is the
program's digest: the logsumexp of its logits over the vocabulary and its
logits at the step's probe ids.

``check`` holds each checked row to two limits, the widest logit gap and
the widest logsumexp gap (``limits`` of the configuration); a step with
any row outside them is wrong (``answers_wrong``, limit 0). The control
(``control=True``) is this reference with the K/V rounded to
``float8_e4m3fn``, one step below the program's bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

QUERY_CHUNK = 512            # query rows an attention block at a time
ROW_CHUNK = 4096             # token rows a product at a time (MLP, logits)
TENSOR_CORE_BF16_OPS_PER_S = 989e12     # H100 SXM, dense bf16
NORM_OPS = 4                 # a norm's square, sum, scale and weight a value
ROPE_OPS = 3                 # two products and a sum a rotated value
SOFTMAX_OPS = 4              # max, exp, sum and scale a logit


class Answers(list):
    """Each command's expected digest, ``[B, 2 + probes]`` float32 as the
    program's answer (column 0 the greedy token, not judged; column 1 the
    logsumexp; then the probes' logits), NaN in the rows not checked, with
    the configuration's ``limits``."""

    limits: dict


def answers(data, config: dict, commands: list, control: bool = False) -> Answers:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sched = data.schedule
    B, P = int(config["batch"]), int(config["probes"])
    out = Answers(np.full((B, 2 + P), np.nan, np.float32) for _ in commands)
    out.limits = dict(config["limits"])
    # each checked session's tokens: (command, row) of its j-th token
    where: dict[int, dict[int, tuple[int, int]]] = {}
    for ci, c in enumerate(commands):
        plan = sched.plan(c.step)
        for r, k in enumerate(plan.seq_ids):
            s = sched.session(k)
            if s.checked:
                j = int(plan.positions[r]) - sched.prompt_len(s.prompt)
                where.setdefault(k, {})[j] = (ci, r)
    if not where:
        return out
    dev = data.weights["embed"].device
    # one block a prompt: its tokens, then each of its sessions' tokens
    blocks, rows = [], []          # rows: each session token's (command, row)
    for p in sorted({sched.session(k).prompt for k in where}):
        sessions = []
        for k in sorted(k for k in where if sched.session(k).prompt == p):
            m = max(where[k]) + 1
            sessions.append(sched.session(k).tokens[:m])
            rows += [where[k].get(j, (-1, -1)) for j in range(m)]
        blocks.append((sched.prompt_tokens[p], sessions))
    x, session_rows = hidden(data.weights, config, blocks, dev, control)
    lse, probe_logits = digest(data.weights, config, x[session_rows], rows, commands,
                               sched, dev)
    for (ci, r), l, pr in zip(rows, lse, probe_logits):
        if ci >= 0:
            out[ci][r, 1] = l
            out[ci][r, 2:] = pr
    return out


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` [N, heads, hd] at ``pos`` [N], the halves
    rotated as pairs (the port's layout)."""
    half = x.shape[-1] // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None, None] * freq
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            seen: torch.Tensor) -> torch.Tensor:
    """Softmax attention of ``q`` [nq, H, hd] over ``k``, ``v`` [nk, KV, hd]
    where ``seen`` [nq, nk] allows; query head ``h`` reads KV head
    ``h // (H / KV)``. Returns [nq, H * hd]."""
    nq, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.view(nq, KV, G, hd).permute(1, 0, 2, 3).reshape(KV, nq * G, hd)
    logits = (qg * hd ** -0.5) @ k.permute(1, 2, 0)                # [KV, nq * G, nk]
    logits = logits.view(KV, nq, G, -1).masked_fill(~seen[None, :, None, :], float("-inf"))
    att = torch.softmax(logits, -1).view(KV, nq * G, -1)
    o = (att @ v.permute(1, 0, 2)).view(KV, nq, G, hd)
    return o.permute(1, 0, 2, 3).reshape(nq, H * hd)


def hidden(w: dict, config: dict, blocks: list, dev, control: bool):
    """The last layer's output [N, d] of every token of every block (a
    prompt's tokens, then each of its sessions' tokens), and which rows are
    sessions' tokens. A prompt token attends to the prompt up to itself,
    a session's token to the whole prompt and its session up to itself."""
    m = config["model"]
    L, H, KV, hd = (int(m[k]) for k in ("num_layers", "num_heads", "num_kv_heads",
                                        "head_dim"))
    eps, theta = float(m["rms_norm_eps"]), float(m["rope_theta"])
    toks, pos, spans = [], [], []   # spans: (block's first row, prompt length, sessions')
    row = 0
    for prompt, sessions in blocks:
        n = len(prompt)
        toks += [prompt, *sessions]
        pos += [np.arange(n)] + [n + np.arange(len(t)) for t in sessions]
        spans.append((row, n, [len(t) for t in sessions]))
        row += n + sum(len(t) for t in sessions)
    ids = torch.from_numpy(np.concatenate(toks)).to(dev)
    p_all = torch.from_numpy(np.concatenate(pos)).to(dev)
    is_session = torch.ones(row, dtype=torch.bool, device=dev)
    for a, n, _ in spans:
        is_session[a:a + n] = False
    x = w["embed"][ids].float()
    for layer in range(L):
        lw = {n: w[n][layer].float() for n in ("ln1", "wq", "wk", "wv", "wo", "ln2",
                                                "gate", "up", "down")}
        attn = torch.empty(row, H * hd, device=dev)
        for a, n, lengths in spans:
            b = a + n + sum(lengths)
            h = _rms(x[a:b], lw["ln1"], eps)
            q = _rope((h @ lw["wq"]).view(-1, H, hd), p_all[a:b], theta)
            k = _rope((h @ lw["wk"]).view(-1, KV, hd), p_all[a:b], theta)
            v = (h @ lw["wv"]).view(-1, KV, hd)
            if control:
                k = k.to(torch.float8_e4m3fn).float()
                v = v.to(torch.float8_e4m3fn).float()
            for c0 in range(0, n, QUERY_CHUNK):          # the prompt, causal
                c1 = min(c0 + QUERY_CHUNK, n)
                seen = torch.ones(c1 - c0, c1, dtype=torch.bool, device=dev).tril(c0)
                attn[a + c0:a + c1] = _attend(q[c0:c1], k[:c1], v[:c1], seen)
            s0 = n
            for ln in lengths:                            # each session
                s1 = s0 + ln
                seen = torch.ones(ln, n + ln, dtype=torch.bool, device=dev).tril(n)
                attn[a + s0:a + s1] = _attend(q[s0:s1], torch.cat([k[:n], k[s0:s1]]),
                                              torch.cat([v[:n], v[s0:s1]]), seen)
                s0 = s1
        for r0 in range(0, row, ROW_CHUNK):
            r1 = min(r0 + ROW_CHUNK, row)
            xr = x[r0:r1] + attn[r0:r1] @ lw["wo"]
            h = _rms(xr, lw["ln2"], eps)
            x[r0:r1] = xr + (torch.nn.functional.silu(h @ lw["gate"]) * (h @ lw["up"])) @ lw["down"]
        del lw, attn
    return x, is_session


def digest(w: dict, config: dict, x: torch.Tensor, rows: list, commands: list, sched,
           dev) -> tuple[np.ndarray, np.ndarray]:
    """Each token's logsumexp over the vocabulary and its logits at its
    step's probes (``rows[i]``: the token's command and row, ``(-1, -1)``
    for none)."""
    eps = float(config["model"]["rms_norm_eps"])
    head, norm = w["head"].float(), w["final_norm"].float()
    probes = np.stack([sched.plan(commands[ci].step).probes if ci >= 0 else
                       np.zeros(int(config["probes"]), np.int64) for ci, _ in rows])
    probes = torch.from_numpy(probes).to(dev)
    lse, picked = [], []
    for r0 in range(0, x.shape[0], ROW_CHUNK):
        logits = _rms(x[r0:r0 + ROW_CHUNK], norm, eps) @ head
        lse.append(torch.logsumexp(logits, -1))
        picked.append(torch.gather(logits, 1, probes[r0:r0 + ROW_CHUNK]))
    return torch.cat(lse).cpu().numpy(), torch.cat(picked).cpu().numpy()


def check(records: list, expected: Answers) -> tuple[dict, int]:
    """``({name: (value, limit)}, steps wrong)`` over the answered records:
    the widest gap of a checked row's probe logits and of its logsumexp
    from the reference's; a NaN gap is infinite."""
    lim = expected.limits
    widest = {"logit_gap": 0.0, "lse_gap": 0.0}
    wrong = 0
    for r, want in zip(records, expected):
        rows = ~np.isnan(want[:, 1])
        if not rows.any():
            continue
        got = np.asarray(r.value, np.float32)[rows]
        gap = {"logit_gap": np.abs(got[:, 2:] - want[rows, 2:]).max(),
               "lse_gap": np.abs(got[:, 1] - want[rows, 1]).max()}
        over = False
        for name, g in gap.items():
            g = float(np.nan_to_num(g, nan=np.inf))
            widest[name] = max(widest[name], g)
            over |= g > lim[name]
        wrong += over
    return ({name: (v, float(lim[name])) for name, v in widest.items()}
            | {"answers_wrong": (wrong, 0)}), wrong


def _widths(config: dict) -> tuple[int, ...]:
    m = config["model"]
    return tuple(int(m[k]) for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                                     "head_dim", "d_ff", "vocab_size"))


def matrix_params(config: dict) -> int:
    """The weights a step multiplies (all but the embedding, which it
    looks up)."""
    L, d, H, KV, hd, ff, V = _widths(config)
    return L * (d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff) + d * V


def work(config: dict, command) -> tuple[int, int]:
    """A step's ``(bytes, operations)``: every weight read once (the
    embedding's rows of the batch alone), the K/V its attends read
    (``kv_tokens`` a layer) and the batch's new K/V written, the logits
    written; the operations outside the tensor cores (``bound.py``'s rate):
    attention's products and softmax, the norms and RoPE. The bf16 matrix
    products are left out: at this batch they bind far below the bytes
    (``tensor_core_seconds``)."""
    L, d, H, KV, hd, ff, V = _widths(config)
    B, item = int(config["batch"]), 2
    weights = matrix_params(config) + L * 2 * d + d + B * d
    kv = 2 * L * KV * hd * (command.kv_tokens + B)
    n_bytes = item * (weights + kv + B * V)
    attn = L * command.kv_tokens * H * (4 * hd + SOFTMAX_OPS)
    per_row = L * (2 * NORM_OPS * d + ROPE_OPS * (H + KV) * hd) + NORM_OPS * d
    return n_bytes, attn + B * per_row


def tensor_core_seconds(config: dict) -> float:
    """The least time of a step's bf16 matrix products at the tensor
    cores' dense rate."""
    return 2 * matrix_params(config) * int(config["batch"]) / TENSOR_CORE_BF16_OPS_PER_S


def attend_work(config: dict, command) -> tuple[int, int]:
    """One layer's attend: ``(bytes, operations)``: the K/V of its rows
    read once, q read and the output written, the zone table and lengths;
    the logits' products, softmax and P.V."""
    L, d, H, KV, hd, ff, V = _widths(config)
    B, item = int(config["batch"]), 2
    mz = int(config["pool"]["max_zones_per_seq"])
    n_bytes = item * (2 * KV * hd * command.kv_tokens + 2 * B * H * hd) + 4 * B * (mz + 1)
    return n_bytes, command.kv_tokens * H * (4 * hd + SOFTMAX_OPS)
