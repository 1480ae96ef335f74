"""ZCSD core: the paper's contribution as a composable library.

  * :mod:`repro_torch.core.programs` — the offload program IR (eBPF analogue)
  * :mod:`repro_torch.core.verifier` — bounded-execution / memory-safety verifier
  * :mod:`repro_torch.core.vm`       — interpreter + eager-PyTorch jit tiers
  * :mod:`repro_torch.core.csd`      — the NvmCsd device (two-part API, stats)
  * :mod:`repro_torch.core.cache`    — shared compiled-executable cache
  * :mod:`repro_torch.core.prefetch` — read/compute overlap primitives
"""
from repro_torch.core.cache import CacheStats, CompiledProgramCache, default_cache
from repro_torch.core.prefetch import LookaheadReader, RingReader, prefetched
from repro_torch.core.programs import (
    Instruction,
    OpCode,
    Program,
    field_reduce,
    filter_count,
    filter_select,
    filter_sum,
    histogram,
)
from repro_torch.core.verifier import VerifierLimits, VerifyError, verify_program
from repro_torch.core.vm import OffloadResult, interpret_program, jit_program, run_oracle
from repro_torch.core.csd import CsdTier, NvmCsd, OffloadStats

__all__ = [
    "Instruction", "OpCode", "Program",
    "filter_count", "filter_sum", "filter_select", "histogram", "field_reduce",
    "VerifyError", "VerifierLimits", "verify_program",
    "OffloadResult", "interpret_program", "jit_program", "run_oracle",
    "NvmCsd", "CsdTier", "OffloadStats",
    "CacheStats", "CompiledProgramCache", "default_cache",
    "LookaheadReader", "RingReader", "prefetched",
]
