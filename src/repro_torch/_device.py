"""Where the port computes, and how host bytes get there.

Every public entry point of :mod:`repro_torch` takes a ``device``. The
default is ``"cuda"``: asking for the card where there is none raises, so a
caller never measures the CPU while believing it measured the GPU. The CPU
runs only when the caller says ``device="cpu"`` (the tests do).

Small operands and results need not pass through device buffers at all:
host memory registered *mapped* (:func:`register_mapped`) has an address
in the card's space, so a kernel reads it, or writes its result to it
(:class:`ResultSlots`), across the link in place.
"""
from __future__ import annotations

import ctypes
import functools
import mmap
import threading
import warnings
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["resolve_device", "host_tensor", "host_to_device", "to_numpy",
           "register_mapped", "ResultSlot", "ResultSlots"]

# cudaHostRegisterPortable | cudaHostRegisterMapped: page-locked for every
# device, and given an address in the card's space
_HOST_REGISTER_MAPPED = 1 | 2


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    this process has no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """``array`` as a CPU tensor sharing its memory (no copy).

    Zone extents arrive as read-only views of the device's backing buffer.
    ``torch.from_numpy`` warns on those because a tensor cannot be made
    read-only; the port only ever reads these tensors (as a copy source or as
    the input of an out-of-place op), so the warning is silenced here, once.
    """
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(array))


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``: an alias on the CPU, one blocking host-to-card
    copy on CUDA (a single DMA when the host memory is page-locked)."""
    t = host_tensor(array)
    return t if device.type == "cpu" else t.to(device)


def to_numpy(t: torch.Tensor, dtype: np.dtype | None = None) -> np.ndarray:
    """Copy a (small) result tensor to the host as numpy, cast to ``dtype``
    when given (the plain paths compute uint32 streams widened to int64)."""
    t = t.detach()
    if t.dtype == torch.uint32:     # copied as its int32 bits
        out = t.view(torch.int32).cpu().numpy().view(np.uint32)
    else:
        out = t.cpu().numpy()
    return out if dtype is None or out.dtype == dtype else out.astype(dtype)


@functools.cache
def _cudart() -> Optional[ctypes.CDLL]:
    """The CUDA runtime PyTorch loaded, for the two calls
    ``torch.cuda.cudart()`` does not bind (``cudaHostGetDevicePointer``,
    ``cudaGetLastError``); None where there is none."""
    try:
        lib = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    except (AttributeError, OSError):       # no CUDA build, or no runtime
        return None
    lib.cudaHostGetDevicePointer.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                             ctypes.c_void_p, ctypes.c_uint]
    lib.cudaHostGetDevicePointer.restype = ctypes.c_int
    lib.cudaGetLastError.restype = ctypes.c_int
    return lib


def register_mapped(address: int, nbytes: int) -> Optional[int]:
    """Page-lock ``nbytes`` of host memory at ``address`` for every device
    and map them into the card's address space (``cudaHostRegisterMapped``).
    Returns the card's address of the first byte, or None, with nothing
    left registered and no error pending, where the runtime refuses
    (file-backed memory, for one). ``cudaHostUnregister`` undoes it."""
    torch.cuda.init()
    rt, cudart = _cudart(), torch.cuda.cudart()
    if rt is None:
        return None
    if int(cudart.cudaHostRegister(address, nbytes, _HOST_REGISTER_MAPPED)):
        rt.cudaGetLastError()       # not an error of the next launch
        return None
    card = ctypes.c_void_p()
    if rt.cudaHostGetDevicePointer(ctypes.byref(card), address, 0) or not card.value:
        rt.cudaGetLastError()
        cudart.cudaHostUnregister(address)
        return None
    return card.value


class ResultSlot:
    """Room for one small result (at most 8 bytes) in page-locked host
    memory that the card writes through ``address``. One command holds it
    from its launch, which sets ``dtype`` and records ``event`` after the
    kernel, to :meth:`wait`."""

    __slots__ = ("address", "host", "event", "dtype", "_views", "_pool")

    def __init__(self, address: int, host: np.ndarray, event, pool: "ResultSlots"):
        self.address = address      # where the card writes
        self.host = host            # the same bytes, as the host reads them
        self.event = event
        self.dtype: Optional[np.dtype] = None
        self._views: dict = {}
        self._pool = pool

    def wait(self) -> np.ndarray:
        """The result as a 0-d array of ``dtype``: waits for ``event``,
        copies the value out and gives the slot back, so what it returns
        never aliases the slot."""
        self.event.synchronize()
        view = self._views.get(self.dtype)
        if view is None:
            view = self._views[self.dtype] = np.ndarray((), self.dtype, self.host)
        value = view.copy()
        self._pool.give(self)
        return value


class ResultSlots:
    """A pool of :class:`ResultSlot` objects, taken one a command in flight
    and given back at its wait, never one a stream: two commands in flight on
    one stream each read their own result. Grows a page at a time, each
    page mapped by ``register(host array) -> card address`` and never given
    back; ``make_event()`` makes each slot's event."""

    SLOT_BYTES = 16                 # the widest result, 8 bytes, 16-aligned

    def __init__(self, register: Callable[[np.ndarray], int],
                 make_event: Callable[[], object]):
        self._register = register
        self._make_event = make_event
        self._lock = threading.Lock()
        self._free: list[ResultSlot] = []
        self._pages: list = []      # the mappings, kept for the process

    def take(self) -> ResultSlot:
        with self._lock:
            if not self._free:
                self._grow()
            return self._free.pop()

    def give(self, slot: ResultSlot) -> None:
        with self._lock:
            self._free.append(slot)

    def _grow(self) -> None:
        page = mmap.mmap(-1, mmap.PAGESIZE)     # page-aligned: its own page
        host = np.frombuffer(page, np.uint8)
        address = self._register(host)
        self._pages.append((page, host))
        n = self.SLOT_BYTES
        self._free.extend(ResultSlot(address + i, host[i:i + n], self._make_event(), self)
                          for i in range(0, host.nbytes, n))
