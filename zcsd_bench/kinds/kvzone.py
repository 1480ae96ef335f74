"""The ``kvzone`` kind: a model served from the zoned KV cache
(``"kind": "kvzone"``).

The port's ``ServeModel`` holds the configuration's model and a
``KVZoneCache`` of every layer; sessions, each a prompt and a teacher-forced
continuation, decode together, one token each a step, each at its own
position, and end and are replaced as they go. A command is one step:
evict the sessions that ended, admit their replacements from the prompt
cache (their prompts' K/V, prefilled in set-up), decode every row. Its
answer is each row's greedy token and the check's digest of its logits
(the logsumexp over the vocabulary and the logits at ``probes`` ids drawn
for the step), one copy to the host.

Everything comes from the seed (:class:`Sessions`): the prompts, which
prompt and how many tokens each session has, its tokens, the probes and
which sessions the reference checks. The warm-up is the schedule's first
``WARM_STEPS`` steps and the command stream its steps after them, so the
check replays exactly what ran. ``spec.py`` says what a kind file gives.
"""

import contextlib
import hashlib
import itertools
from dataclasses import dataclass

import numpy as np

from zcsd_bench import traffic
from zcsd_bench.deploy import counter, port_path

ROOT_SPAN = "serve.step"          # serve/step.py::ServeModel.decode_sessions
# the readers of the zoned cache's layers (``metrics/``); on the card the
# step's layers replay as one CUDA graph, so the per-layer host spans
# (``kv.append``, ``kv.attend``) are recorded only while it is captured
LAYER_METRICS = ("kv_admit_ms", "kv_table_us", "paged_roofline")
WARM_STEPS = 2                    # the first step builds the paged kernel
# the cut's limits (``cut_for_tests``), between its program's widest gaps and
# its control's on the CPU
TEST_LIMITS = {"logit_gap": 0.4, "lse_gap": 0.025}


@dataclass(frozen=True)
class Command:
    """One decode step of every session: ``kv_tokens`` is the sum over its
    rows of their length with the new token, the tokens each layer's attend
    reads, and ``nbytes`` their K/V bytes over all layers. A warm-up step
    carries 0 for both: its lengths depend on the seed, which the warm-up
    does not take, and no metric counts it."""

    step: int
    kv_tokens: int
    nbytes: int


@dataclass(frozen=True)
class Session:
    prompt: int
    tokens: np.ndarray            # its teacher-forced inputs, one a step
    checked: bool                 # one the reference answers


@dataclass(frozen=True)
class Plan:
    """What step ``step`` does: the sessions evicted and the ``(row,
    session)`` admitted before it, then each row's session, its input token
    and position, and the step's probe ids."""

    step: int
    evicted: tuple
    admitted: tuple
    seq_ids: tuple
    tokens: np.ndarray            # int64 [B]
    positions: np.ndarray         # int64 [B]
    probes: np.ndarray            # int64 [probes]

    @property
    def kv_tokens(self) -> int:
        return int(self.positions.sum()) + len(self.positions)


def _log_uniform(rng: np.random.Generator, lo: int, hi: int, size=None):
    """Integers whose log is uniform over ``[log lo, log (hi + 1))``."""
    x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size))
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


class Sessions:
    """The schedule of a seed. ``prompts`` prompts of lengths drawn from
    ``sessions.prompt_tokens``; session ``k`` draws its prompt uniformly,
    its length from ``sessions.output_tokens``, its tokens uniformly over
    the vocabulary, and whether the reference checks it (with probability
    ``check_share``), from a generator of its own. Rows ``0..B-1`` start
    with sessions ``0..B-1``; a session that has decoded all its tokens is
    evicted before the next step and the next session takes its row. Plans
    are made in order and kept, so ``plan(step)`` is the same whoever asks."""

    def __init__(self, config: dict, seed: int):
        self._seed = traffic.seed_value(seed)
        self._vocab = int(config["model"]["vocab_size"])
        self._batch = int(config["batch"])
        self._probes = int(config["probes"])
        self._share = float(config["check_share"])
        s = config["sessions"]
        self._out = [int(n) for n in s["output_tokens"]]
        rng = np.random.default_rng([self._seed, 0])
        lengths = _log_uniform(rng, *(int(n) for n in s["prompt_tokens"]),
                               size=int(config["prompts"]))
        self.prompt_tokens = [rng.integers(0, self._vocab, int(n)) for n in lengths]
        self._sessions: dict[int, Session] = {}
        self._rows = list(range(self._batch))      # each row's session
        self._done = [0] * self._batch             # tokens it has decoded
        self._next = self._batch
        self._plans: list[Plan] = []

    def prompt_len(self, p: int) -> int:
        return len(self.prompt_tokens[p])

    def session(self, k: int) -> Session:
        if k not in self._sessions:
            rng = np.random.default_rng([self._seed, 1, k])
            prompt = int(rng.integers(len(self.prompt_tokens)))
            n = int(_log_uniform(rng, *self._out))
            tokens = rng.integers(0, self._vocab, n)
            self._sessions[k] = Session(prompt, tokens, bool(rng.random() < self._share))
        return self._sessions[k]

    def plan(self, step: int) -> Plan:
        while len(self._plans) <= step:
            self._plans.append(self._advance(len(self._plans)))
        return self._plans[step]

    def _advance(self, step: int) -> Plan:
        evicted, admitted = [], []
        for r, k in enumerate(self._rows):
            if self._done[r] == len(self.session(k).tokens):
                evicted.append(k)
                admitted.append((r, self._next))
                self._rows[r], self._done[r] = self._next, 0
                self._next += 1
        tokens = np.empty(self._batch, np.int64)
        positions = np.empty(self._batch, np.int64)
        for r, k in enumerate(self._rows):
            s = self.session(k)
            tokens[r] = s.tokens[self._done[r]]
            positions[r] = self.prompt_len(s.prompt) + self._done[r]
            self._done[r] += 1
        probes = np.random.default_rng([self._seed, 2, step]).integers(
            0, self._vocab, self._probes)
        return Plan(step, tuple(evicted), tuple(admitted), tuple(self._rows), tokens,
                    positions, probes)


@dataclass
class Data:
    """The weights, in the kind's plain layout on the device (``weights``),
    and the schedule (``schedule``, which holds the prompts)."""

    weights: dict
    schedule: Sessions


# the plain layout: name -> shape, from the widths (``L``: a leading layer axis)
def weight_shapes(m: dict) -> dict:
    L, d, H, KV, hd = (int(m[k]) for k in ("num_layers", "d_model", "num_heads",
                                            "num_kv_heads", "head_dim"))
    ff, V = int(m["d_ff"]), int(m["vocab_size"])
    return {"embed": (V, d), "ln1": (L, d), "wq": (L, d, H * hd), "wk": (L, d, KV * hd),
            "wv": (L, d, KV * hd), "wo": (L, H * hd, d), "ln2": (L, d),
            "gate": (L, d, ff), "up": (L, d, ff), "down": (L, ff, d),
            "final_norm": (d,), "head": (d, V)}


NORMS = ("ln1", "ln2", "final_norm")


def make_data(config: dict, seed: int, device) -> Data:
    """Every matrix N(0, ``init_std``²) and every norm's scale 1, in the
    configuration's dtype on ``device``; a leaf's draw has a generator of
    its own, seeded from the seed and its name."""
    import torch
    dtype = getattr(torch, config["dtype"])
    weights = {}
    for name, shape in weight_shapes(config["model"]).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        if name in NORMS:
            t.fill_(1.0)
        else:
            key = f"{traffic.seed_value(seed)}:{name}".encode()
            gen = torch.Generator(device=device)
            gen.manual_seed(int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1)
            t.normal_(0.0, float(config["init_std"]), generator=gen)
        weights[name] = t
    return Data(weights, Sessions(config, seed))


def model_config(config: dict):
    """The port's ``ModelConfig``: granite-8b's, at the file's widths and
    dtype."""
    port_path()
    from repro_torch.configs.granite_8b import CONFIG
    m = config["model"]
    if m["arch"] != CONFIG.arch_id:
        raise ValueError(f"the kvzone kind serves {CONFIG.arch_id}, not {m['arch']}")
    widths = {k: m[k] for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                                "head_dim", "d_ff", "vocab_size", "rope_theta")}
    return CONFIG.replace(**widths, param_dtype=config["dtype"],
                          compute_dtype=config["dtype"])


def params_tree(cfg, w: dict) -> dict:
    """The port's params tree of the plain weights, as views (no copy)."""
    L, d, H, KV, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
    layer = {"ln1": {"scale": w["ln1"]},
             "attn": {"wq": w["wq"].view(L, d, H, hd), "wk": w["wk"].view(L, d, KV, hd),
                      "wv": w["wv"].view(L, d, KV, hd), "wo": w["wo"].view(L, H, hd, d)},
             "ln2": {"scale": w["ln2"]},
             "mlp": {"gate": w["gate"], "up": w["up"], "down": w["down"]}}
    return {"embed": {"tok": w["embed"], "head": w["head"]},
            "segments": [{"k0_attn_mlp": layer}],
            "final_norm": {"scale": w["final_norm"]}}


class Deployment:
    """The model on the card with its zoned cache: the prompts prefilled
    into the prompt cache and the first ``batch`` sessions admitted."""

    def __init__(self, config: dict, data: Data, device: str):
        port_path()
        import torch
        from repro_torch._device import host_to_device
        from repro_torch.serve import KVZoneCache, ServeModel
        self._torch, self._h2d = torch, host_to_device
        self._threads = None
        if torch.device(device).type == "cpu":
            # one intra-op thread while it serves, as run.py sets on the card's
            # host: a step's small products and reductions would otherwise wait
            # for every thread of the pool, and on a busy CPU a step takes
            # hundreds of times as long
            self._threads = torch.get_num_threads()
            torch.set_num_threads(1)
        self.config = config
        self.schedule = data.schedule
        cfg = model_config(config)
        pool = config["pool"]
        # the cache first: the paged kernel it needs builds beside the prefill
        self.cache = KVZoneCache(num_layers=cfg.num_layers, num_zones=int(pool["num_zones"]),
                                 zone_len=int(pool["zone_len"]), kv_heads=cfg.num_kv_heads,
                                 head_dim=cfg.head_dim,
                                 max_zones_per_seq=int(pool["max_zones_per_seq"]),
                                 dtype=getattr(torch, config["dtype"]), device=device)
        self.model = ServeModel(cfg, params_tree(cfg, data.weights), device=device)
        self.device = self.model.device
        self.prompts = []             # each prompt's K and V, [layers, n, KV, hd]
        for toks in self.schedule.prompt_tokens:
            batch = {"tokens": host_to_device(toks[None], self.device)}
            _, k, v = self.model.prompt_kv(batch)
            self.prompts.append((k[:, 0], v[:, 0]))
            del k, v
        for k in range(int(config["batch"])):
            self.cache.admit(k, *self.prompts[self.schedule.session(k).prompt])
        self._step = 0

    def run(self, cmd: Command):
        torch = self._torch
        if cmd.step != self._step:
            raise RuntimeError(f"step {cmd.step} asked for, step {self._step} next")
        plan = self.schedule.plan(cmd.step)
        self._step += 1
        admit = [(k, *self.prompts[self.schedule.session(k).prompt])
                 for _, k in plan.admitted]
        B = len(plan.seq_ids)
        ids = self._h2d(np.concatenate([plan.tokens, plan.probes]), self.device)
        nxt, logits = self.model.decode_sessions(self.cache, list(plan.seq_ids),
                                                 ids[:B, None], evict=plan.evicted,
                                                 admit=admit)
        lf = logits.float()
        digest = torch.cat([nxt.float(), torch.logsumexp(lf, -1)[:, None], lf[:, ids[B:]]], 1)
        return digest.cpu().numpy(), None

    def launches(self) -> int:
        """The port's kernel launch counters, summed."""
        return sum(counter(c) for c in self.config["kernel"]["launch_counters"])

    def close(self) -> None:
        """Free the zones, the prompt cache and the model's views."""
        self.cache = self.prompts = self.model = None
        if self.device.type == "cuda":
            self._torch.cuda.empty_cache()
        if self._threads is not None:
            self._torch.set_num_threads(self._threads)


def token_bytes(config: dict) -> int:
    """A token's K/V bytes over every layer."""
    m = config["model"]
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[config["dtype"]]
    return 2 * int(m["num_layers"]) * int(m["num_kv_heads"]) * int(m["head_dim"]) * itemsize


def _validate(mix: dict) -> None:
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError(f"unsupported traffic: {mix.get('clients')} clients, "
                         f"{mix.get('loop')!r} loop")


def commands(config: dict, mix: dict, seed: int):
    """The schedule's steps after the warm-up, endless."""
    _validate(mix)
    sched, tb = Sessions(config, seed), token_bytes(config)
    for step in itertools.count(WARM_STEPS):
        n = sched.plan(step).kv_tokens
        yield Command(step, n, n * tb)


def warmup(config: dict, mix: dict) -> list[Command]:
    """The schedule's first steps (the first builds the paged kernel)."""
    _validate(mix)
    return [Command(step, 0, 0) for step in range(WARM_STEPS)]


def cut_for_tests(config: dict, mix: dict) -> tuple[dict, dict]:
    """granite-8b's ``reduced()`` widths at 2 layers, 8 sessions over 4
    prompts of 16-40 tokens with 4-16 tokens each, 8-token zones, every
    session checked. The init keeps each product's scale at the published
    widths' (0.02 x sqrt(4096 / 64)), and the limits are the cut's own,
    between its program's readings and its control's."""
    port_path()
    from repro_torch.configs.granite_8b import reduced
    r = reduced()
    model = dict(config["model"], num_layers=2, d_model=r.d_model, num_heads=r.num_heads,
                 num_kv_heads=r.num_kv_heads, head_dim=r.head_dim, d_ff=r.d_ff,
                 vocab_size=r.vocab_size)
    return dict(config, model=model, init_std=0.16, batch=8, prompts=4,
                pool={"num_zones": 56, "zone_len": 8, "max_zones_per_seq": 7},
                sessions={"prompt_tokens": [16, 40], "output_tokens": [4, 16]},
                check_share=1.0, limits=TEST_LIMITS), mix


# Faults planted in the port's timed path, to see ``correct`` come out false.

@contextlib.contextmanager
def lost_append():
    """Row 0's new K/V never written to layer 0's zones: the row later
    reads what its slots held before (zeros, or an evicted session's K/V)."""
    port_path()
    from repro_torch.serve.kv_zones import KVZoneCache
    real = KVZoneCache.write

    def write(self, layer, slots, k_new, v_new):
        if layer == 0:
            slots, k_new, v_new = tuple(s[1:] for s in slots), k_new[1:], v_new[1:]
        return real(self, layer, slots, k_new, v_new)
    KVZoneCache.write = write
    try:
        yield
    finally:
        KVZoneCache.write = real


@contextlib.contextmanager
def stale_table():
    """Row 0's newest zone missing from each step's zone table, as a table
    built before its zone was taken."""
    port_path()
    from repro_torch.serve.kv_zones import KVZoneCache
    real = KVZoneCache.reserve

    def reserve(self, seq_ids):
        step = real(self, seq_ids)
        step.table[0, len(self._seqs[seq_ids[0]].zones) - 1] = -1
        return step
    KVZoneCache.reserve = reserve
    try:
        yield
    finally:
        KVZoneCache.reserve = real


def _some_step_wrong(result: dict, config: dict, mix: dict) -> bool:
    return result["checks"]["answers_wrong"]["value"] > 0


FAULTS = {"lost_append": (lost_append, _some_step_wrong),
          "stale_table": (stale_table, _some_step_wrong)}
