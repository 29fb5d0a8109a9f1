"""Ring attention: wrappers of the hand-written CUDA kernels of
``csrc/ring_attention.cu`` (K10 forward, K11 backward), which run the
whole ring in one launch a card, and the plain PyTorch versions of one
ring step with the rotation of the K/V slots.

A ring of n ranks holds a sequence of T = n * Tl rows: rank r owns rows
[r Tl, (r + 1) Tl). At step s rank r folds the K/V chunk of rank
``src = (r - s) mod n``. Every buffer is a list of the n ranks' rows:
``q``, ``k``, ``v``, ``do``, ``o``, ``dq``, ``dk``, ``dv`` (BH, Tl, D) in
the io dtype (float32 or bfloat16), ``L``, ``delta`` (BH, Tl) float32,
each rank's on its own device (several ranks may share one). A rank's
rows may be a view: where the ranks share a device,
``parallel.ring_pallas`` passes views of rank-stacked (BH, T, D) tensors,
whose heads lie T rows apart; a tensor of a rank's own has them Tl apart.
One call's tensors share that head stride.

``ring_fwd_cuda`` writes (o, L) and ``ring_bwd_cuda`` (dq, dk, dv) into the
lists it is given, each in ONE call over all n steps: each block loops
over the steps in the ring's order and reads chunk src where it lies,
through a table of the ranks' base pointers, with its running state in
registers, so no chunk is copied and no state goes to device memory
between steps. The ranks' rows lie in one of three places:

- one card: one launch covers every rank;
- several cards of this process: one launch a card covers the ranks
  whose rows lie there, and the kernels read the peers' chunks in place
  (peer access, which must be possible: a pair that cannot reach each
  other raises). Every launch waits on an event that each source card
  recorded on its current stream before the first launch, and each
  source's stream waits on every launch after the last one: the cards run
  at once, and no chunk is rewritten or freed under a reader. One card
  runs the same events on its one stream;
- several processes (``arena=``, a ``RingArena``): each list holds this
  process's ranks and None for the others'. Each process copies its
  ranks' input chunks into its arena, a ``cudaMalloc`` whose CUDA IPC
  handle every peer opened once, and launches once for each run of its
  ranks, reading the other processes' chunks from their arenas (on
  another card through peer access: a pair without it raises); the
  outputs stay in its own tensors, since every block writes only the rows
  of the rank it owns. Interprocess events and a host handshake a call
  order the copies, the reads and the next overwrite (``RingArena``).

D is the padded head width, one of
``SUPPORTED_D``; ``scale`` is 1/sqrt(true d_head). ``slopes`` is a
float32 (H,) tensor of ALiBi slopes (head h of batch b is row b H + h) or
None.

On a CUDA tensor the wrappers launch the kernels or raise; they validate
what the kernels do not take and substitute nothing. Each wrapper's
``launches`` counts its launches (one per ring call on one card; K11's
dq and dk/dv kernels count as one).

The plain versions compute the same function the TPU's way, one step at a
time: ``ring_fwd_step_ref`` / ``ring_bwd_step_ref`` update per-rank state
buffers from the chunks in a K/V slot (the n ranks' (2, BH, Tl, D)) or an
f32 bundle slot (the n ranks' (4, BH, Tl, D) = (k, v, dk, dv)), which
``rotate`` moves one hop between steps (``parallel.ring_pallas`` drives
them; ``chunk_live`` decides as the kernels do). The CPU tests hold them
against the JAX package's ring in interpret mode, and a card run holds the
kernels against them.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from .build import build

__all__ = ["ring_fwd_cuda", "ring_bwd_cuda", "ring_fwd_step_ref",
           "ring_bwd_step_ref", "rotate", "chunk_live", "padded_d",
           "SUPPORTED_D", "RingArena", "ring_arena", "release_ring_arenas"]

SUPPORTED_D = (32, 64, 128, 256)
MAX_BH = 65535  # batch * heads rides the grid's y dimension
MAX_RANKS = 32  # csrc/ring_attention.cu's table width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_N_IN, _N_OUT = 6, 3  # q, k, v, dO, L, delta; o, L | dq, dk, dv
_TABLE = ctypes.c_void_p * ((_N_IN + _N_OUT) * MAX_RANKS)


def padded_d(d: int) -> int:
    """The smallest kernel width that holds a head of ``d`` columns."""
    for w in SUPPORTED_D:
        if d <= w:
            return w
    raise ValueError(f"d_head {d} is wider than the ring kernels' widest, "
                     f"{SUPPORTED_D[-1]}")


def chunk_live(src: int, r: int, Tl: int, causal: bool, window) -> bool:
    """Whether the K/V chunk of rank ``src`` can hold a key visible to rank
    ``r`` (``ring_pallas.py:74``): causal bans the future chunks, and a
    window the chunks whose newest key is window - 1 or more behind r's
    oldest row."""
    if not causal:
        return True
    live = src <= r
    if window is not None:
        live = live and (r - src - 1) * Tl < window - 1
    return live


def rotate(cur, nxt):
    """One hop of the ring over the ranks' slots: rank r + 1 receives rank
    r's chunk, rank 0 rank n - 1's; one copy a rank, to the receiver's
    device."""
    for r, x in enumerate(cur):
        nxt[(r + 1) % len(cur)].copy_(x)


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build("ring_attention")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # dtype, d, table, hs, slopes, BH, H, n, Tl, r0, nr, causal, window,
    # scale, stream
    args = ([i32, i32, ptr, ctypes.c_longlong, ptr] + [i32] * 8
            + [f32, ptr])
    for fn in (lib.ring_fwd_launch, lib.ring_bwd_launch):
        fn.argtypes = args
        fn.restype = i32
    lib.ring_enable_peer.argtypes = [i32, i32]
    lib.ring_enable_peer.restype = i32
    out, buf = ctypes.POINTER(ptr), ctypes.c_char_p
    for fn, argtypes in ((lib.ring_ipc_alloc, [i32, ctypes.c_longlong, out,
                                               buf]),
                         (lib.ring_ipc_open, [i32, buf, out]),
                         (lib.ring_ipc_close, [i32, ptr]),
                         (lib.ring_ipc_free, [i32, ptr]),
                         (lib.ring_ipc_copy, [ptr, ptr, ctypes.c_longlong,
                                              ptr])):
        fn.argtypes = argtypes
        fn.restype = i32
    lib.ring_ipc_handle_bytes.restype = i32
    lib.ring_max_ranks.restype = i32
    if lib.ring_max_ranks() != MAX_RANKS:
        raise RuntimeError("ring_attention.cu's MAX_RANKS differs from the "
                           "wrapper's")
    return lib


@functools.cache
def _enable_peer(dev: int, peer: int) -> None:
    """Let card ``dev``'s kernels read card ``peer``'s memory, or raise:
    a pair that cannot reach each other has no copy fallback."""
    rc = _lib().ring_enable_peer(dev, peer)
    if rc:
        raise RuntimeError(f"ring attention: cuda:{dev} cannot read "
                           f"cuda:{peer}'s memory (peer access, code {rc})")


def _check(name, io, rows, H, slopes, window):
    """Validate a call's per-rank lists: ``io`` kinds of (BH, Tl, D) in one
    dtype, ``rows`` kinds of float32 (BH, Tl); rank x's all on one CUDA
    device, each with the same head stride hs (rows from one head to the
    next; any when BH is 1) and unit strides inside a head. Returns (n, BH,
    Tl, D, hs, the ranks' device indices)."""
    n = len(io[0])
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{name}: a ring of 1 to {MAX_RANKS} ranks, got {n}")
    if any(len(kind) != n for kind in io + rows):
        raise ValueError(f"{name}: every per-rank list needs {n} entries")
    q0 = io[0][0]
    if q0.dim() != 3:
        raise ValueError(f"{name}: a rank's q must be (BH, Tl, D), got "
                         f"{tuple(q0.shape)}")
    devs = [t.get_device() for t in io[0]]  # -1 off CUDA
    if min(devs) < 0:
        raise ValueError(f"{name} needs every rank's tensors on a CUDA "
                         "device")
    dt, shape = q0.dtype, q0.shape
    if dt not in _DTYPE_CODE:
        raise ValueError(f"{name}: float32 or bfloat16, got {dt}")
    BH, Tl, D = shape
    if D not in SUPPORTED_D:
        raise ValueError(f"{name}: head width {D} unsupported (the kernels "
                         f"are built for {SUPPORTED_D}; pad with padded_d)")
    hs = q0.stride(0) // D if BH > 1 else Tl
    io_st, row_st = (D, 1), (1,)
    if BH > 1:
        io_st, row_st = (hs * D,) + io_st, (hs,) + row_st
    for kind in io:
        for t, dv in zip(kind, devs):
            st = t.stride()
            if (t.get_device() != dv or t.dtype != dt or t.shape != shape
                    or (st if BH > 1 else st[1:]) != io_st
                    or t.data_ptr() % 16):
                raise ValueError(
                    f"{name}: every rank's q, k, v, do and outputs must be "
                    f"{dt} {tuple(shape)} with strides {io_st} (the head's "
                    "first when BH > 1), 16-byte aligned, on the rank's "
                    f"device; got {t.dtype} {tuple(t.shape)} {st} on "
                    f"{t.device}")
    for kind in rows:
        for t, dv in zip(kind, devs):
            st = t.stride()
            if (t.get_device() != dv or t.dtype != torch.float32
                    or t.shape != (BH, Tl)
                    or (st if BH > 1 else st[1:]) != row_st):
                raise ValueError(f"{name}: L and delta must be float32 "
                                 f"({BH}, {Tl}) with strides {row_st} on "
                                 "the rank's device")
    if hs < Tl or n * Tl >= 2 ** 31 or BH * hs >= 2 ** 31:
        raise ValueError(f"{name}: T {n * Tl} (head stride {hs}) past the "
                         "kernels' int positions")
    if not 0 < BH <= MAX_BH or H < 1 or BH % H:
        raise ValueError(f"{name}: BH {BH} must be in (0, {MAX_BH}] and a "
                         f"multiple of H {H}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got "
                         f"{window}")
    if slopes is not None and (slopes.dtype != torch.float32
                               or slopes.shape != (H,)):
        raise ValueError(f"{name}: slopes must be float32 ({H},)")
    return n, BH, Tl, D, hs, devs


def _runs(devices):
    """(device, r0, nr) for each run of consecutive ranks on one device."""
    out = []
    for x, dev in enumerate(devices):
        if out and out[-1][0] == dev:
            out[-1][2] += 1
        else:
            out.append([dev, x, 1])
    return [tuple(r) for r in out]


@functools.cache
def _event(dev: int, i: int):
    """Event ``i`` of card ``dev``, made once and recorded again by every
    call: a wait takes the record that is newest when it is issued."""
    with torch.cuda.device(dev):
        return torch.cuda.Event()


def _launch(name, entry, counter, ins, outs, rows, slopes, H, causal,
            window, scale, arena=None):
    """Launch the library's ``entry`` once per run of ranks on one device
    (the library is built on the first call that passes the checks).
    ``ins`` and ``outs`` are the table's kinds in its order (each the n
    ranks' tensors), ``rows`` the float32 (BH, Tl) kinds among them. With
    ``arena`` the ranks lie in several processes (``_launch_ipc``)."""
    if arena is not None:
        _launch_ipc(name, entry, counter, arena, ins, outs, rows, slopes, H,
                    causal, window, scale)
        return
    io = [k for k in ins + outs if all(k is not r for r in rows)]
    n, BH, Tl, D, hs, devs = _check(name, io, rows, H, slopes, window)
    fn = getattr(_lib(), entry)
    table = _TABLE()
    for i, kind in enumerate(ins + [()] * (_N_IN - len(ins)) + outs):
        table[i * MAX_RANKS:i * MAX_RANKS + len(kind)] = [
            t.data_ptr() for t in kind]
    sources = list(dict.fromkeys(devs))
    ready = []
    for src in sources:  # every chunk written before any card reads it
        ev = _event(src, 0)
        ev.record(torch.cuda.current_stream(src))
        ready.append(ev)
    done = []
    for j, (dev, r0, nr) in enumerate(_runs(devs)):
        for src in sources:
            if src != dev:
                _enable_peer(dev, src)
        stream = torch.cuda.current_stream(dev)
        for ev in ready:
            stream.wait_event(ev)
        sl = None if slopes is None else slopes.to(dev)
        with torch.cuda.device(dev):
            rc = fn(_DTYPE_CODE[io[0][0].dtype], D, table, hs,
                    None if sl is None else sl.data_ptr(), BH, H, n, Tl, r0,
                    nr, int(bool(causal)), window or 0, float(scale),
                    stream.cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed (code {rc})")
        counter.launches += 1
        ev = _event(dev, 1 + j)
        ev.record(stream)
        done.append(ev)
    for src in sources:  # no chunk rewritten or freed under a reader
        stream = torch.cuda.current_stream(src)
        for ev in done:
            stream.wait_event(ev)


def _spans(positions):
    """(r0, nr) for each run of consecutive ring positions."""
    out = []
    for x in positions:
        if out and out[-1][0] + out[-1][1] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return [tuple(r) for r in out]


def _launch_ipc(name, entry, counter, arena, ins, outs, rows, slopes, H,
                causal, window, scale):
    """``_launch`` for a ring whose ranks lie in several processes: the
    lists hold this process's ranks' tensors at their ring positions
    (``arena.members[arena.me]``) and None elsewhere. The inputs go
    through ``arena`` (copied into its slot, read by every process), the
    outputs stay in this process's tensors; one launch per run of this
    process's ranks."""
    mine = arena.members[arena.me]
    n = arena.n
    if n > MAX_RANKS:
        raise ValueError(f"{name}: a ring of 1 to {MAX_RANKS} ranks, got {n}")
    if any(len(kind) != n for kind in ins + outs):
        raise ValueError(f"{name}: every per-rank list needs the ring's {n} "
                         "entries")
    pick = lambda kinds: [[kind[x] for x in mine] for kind in kinds]
    io = pick([k for k in ins + outs if all(k is not r for r in rows)])
    _, BH, Tl, D, hs, devs = _check(name, io, pick(rows), H, slopes, window)
    if hs != Tl or any(dv != arena.device for dv in devs):
        raise ValueError(f"{name}: across processes every rank's chunk is "
                         f"one contiguous (BH, Tl, D) tensor on "
                         f"cuda:{arena.device}")
    fn = getattr(_lib(), entry)
    sl = None if slopes is None else slopes.to(arena.device)

    def launch(tab_in):
        table = _TABLE()
        for i, kind in enumerate(tab_in):
            table[i * MAX_RANKS:i * MAX_RANKS + n] = kind
        for i, kind in enumerate(outs):
            for x in mine:
                table[(_N_IN + i) * MAX_RANKS + x] = kind[x].data_ptr()
        stream = torch.cuda.current_stream(arena.device)
        for r0, nr in _spans(mine):
            with torch.cuda.device(arena.device):
                rc = fn(_DTYPE_CODE[io[0][0].dtype], D, table, Tl,
                        None if sl is None else sl.data_ptr(), BH, H, n, Tl,
                        r0, nr, int(bool(causal)), window or 0,
                        float(scale), stream.cuda_stream)
            if rc:
                raise RuntimeError(f"{name} launch failed (code {rc})")
            counter.launches += 1

    arena.run(pick(ins), launch)


def ring_fwd_cuda(q, k, v, o, L, *, H: int, causal: bool, window, slopes,
                  scale: float, arena=None):
    """K10 over the whole ring: from the n ranks' q, k, v (BH, Tl, D) into
    their o (BH, Tl, D) in q's dtype and L (BH, Tl) float32; one launch
    per run of ranks on a device. With ``arena`` (a ``RingArena``) the
    ranks lie in several processes: each list holds this process's ranks
    and None for the others'."""
    _launch("ring_fwd_cuda", "ring_fwd_launch", ring_fwd_cuda,
            [q, k, v], [o, L], [L], slopes, H, causal, window, scale, arena)


def ring_bwd_cuda(q, k, v, do, L, delta, dq, dk, dv, *, H: int,
                  causal: bool, window, slopes, scale: float, arena=None):
    """K11 over the whole ring: into the n ranks' dq, dk, dv (BH, Tl, D) in
    q's dtype, from the forward's L and delta = rowsum(dO * O) (both
    float32 (BH, Tl)); the dq pass, then the dk/dv pass, one launch of
    each per run of ranks on a device. ``arena`` as for the forward."""
    _launch("ring_bwd_cuda", "ring_bwd_launch", ring_bwd_cuda,
            [q, k, v, do, L, delta], [dq, dk, dv], [L, delta], slopes, H,
            causal, window, scale, arena)


# -- rings across processes: the arena and its ordering ----------------------

_ALIGN = 256  # bytes: every region of an arena starts on this boundary
_KINDS = 6    # regions a rank in a slot: q, k, v, dO, L, delta
# what a handshake agrees on, by phase
_CALL, _GROW, _RELEASE = 1, 2, 3


class _IpcOps:
    """The calls a ``RingArena`` makes, one method each, so that a test
    can stand in for the card and the group: memory through the library's
    ``ring_ipc_*`` entry points, events through ``torch.cuda.Event(
    interprocess=True)`` and its IPC handles, the exchange and the
    handshake over the ring's ``torch.distributed`` sub-group ``pg``."""

    def __init__(self, pg):
        self.pg = pg

    @staticmethod
    def _ok(what, rc):
        if rc:
            raise RuntimeError(f"ring arena: {what} failed (code {rc})")

    def alloc(self, device, nbytes):
        lib = _lib()
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.ring_ipc_handle_bytes())
        self._ok(f"cudaMalloc/cudaIpcGetMemHandle of {nbytes} bytes on "
                 f"cuda:{device}", lib.ring_ipc_alloc(
                     device, nbytes, ctypes.byref(ptr), handle))
        return ptr.value, handle.raw

    def open(self, device, handle):
        ptr = ctypes.c_void_p()
        self._ok(f"cuda:{device} opening a peer process's arena "
                 "(cudaIpcOpenMemHandle; a peer on another card needs peer "
                 "access)", _lib().ring_ipc_open(device, handle,
                                                 ctypes.byref(ptr)))
        return ptr.value

    def close(self, device, ptr):
        self._ok("cudaIpcCloseMemHandle", _lib().ring_ipc_close(device, ptr))

    def free(self, device, ptr):
        self._ok("cudaFree", _lib().ring_ipc_free(device, ptr))

    def copy(self, dst, src, stream):
        self._ok("cudaMemcpyAsync into the arena", _lib().ring_ipc_copy(
            dst, src.data_ptr(), src.numel() * src.element_size(),
            stream.cuda_stream))

    @staticmethod
    def stream(device):
        return torch.cuda.current_stream(device)

    @staticmethod
    def event(device):
        """A new interprocess event of ``device`` and its IPC handle."""
        with torch.cuda.device(device):
            ev = torch.cuda.Event(interprocess=True)
            return ev, ev.ipc_handle()

    @staticmethod
    def open_event(device, handle):
        return torch.cuda.Event.from_ipc_handle(device, handle)

    @staticmethod
    def record(ev, stream):
        ev.record(stream)

    @staticmethod
    def wait(stream, ev):
        stream.wait_event(ev)

    @staticmethod
    def sync(ev):
        ev.synchronize()

    def exchange(self, obj):
        """Every process's ``obj``, in the group's process order."""
        import torch.distributed as dist

        out = [None] * dist.get_world_size(self.pg)
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def handshake(self, vec):
        """The element-wise max of every process's ``vec`` (ints): returns
        only once every process has called it."""
        import torch.distributed as dist

        t = torch.tensor(vec, dtype=torch.int64)
        if dist.get_backend(self.pg) != "gloo":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return t.tolist()


class RingArena:
    """This process's share of a ring whose ranks lie in several processes
    on cards that can read each other's memory: ``members[p]`` are the
    ring positions of the p-th process's ranks (processes in group
    order), ``me`` this process's index, ``device`` its card.

    The arena is one ``cudaMalloc`` of two slots; a slot holds, for each
    of this process's ranks, the regions of one call's inputs (q, k, v;
    the backward's dO, L, delta too), each on a 256-byte boundary, its
    chunk's heads Tl rows apart. Every process exports its arena's handle
    and opens every peer's once (never its own: a process reads its own
    slots by their pointers); a call that needs more memory grows every
    process's arena together and swaps the handles again. Two
    interprocess events a slot, "ready" and "done", each process's own
    and opened by every peer.

    A call (``run``), in every process in the same order (the tape keeps
    the backward's): wait on every process's "done" of the call two
    before, the last one that read this slot; copy this process's chunks
    into the slot; record "ready"; the handshake, a host all-reduce over
    the group, after which every peer's "ready" record has been issued;
    wait on every peer's "ready"; launch over the table (this process's
    slots for its ranks, the opened peer slots for the others'); record
    "done". No flag is spun on and nothing waits on the host but the
    handshake. ``handshake_s`` sums the host seconds the calls spent in
    it; ``opened`` counts the peer handles opened."""

    def __init__(self, members, me, device, ops):
        self.members = [list(m) for m in members]
        self.me, self.device, self.ops = me, int(device), ops
        self.k = max(len(m) for m in self.members)
        self.n = sum(len(m) for m in self.members)
        self.calls = 0
        self.cap = 0
        self.base = None
        self.peer_base = {}
        self.opened = 0
        self.handshake_s = 0.0
        self.handshakes = 0
        evs = [ops.event(self.device) for _ in range(4)]
        self.ready = [e for e, _ in evs[:2]]
        self.done = [e for e, _ in evs[2:]]
        handles = ops.exchange([h for _, h in evs])
        peers = [p for p in range(len(self.members)) if p != me]
        self.peer_ready = {p: [ops.open_event(self.device, h)
                               for h in handles[p][:2]] for p in peers}
        self.peer_done = {p: [ops.open_event(self.device, h)
                              for h in handles[p][2:]] for p in peers}

    def _agree(self, *vals):
        """The handshake, which also checks that every process is at the
        same step of the protocol with the same sizes."""
        vec = [x for v in vals for x in (v, -v)]
        got = self.ops.handshake(vec)
        if got != vec:
            raise RuntimeError(f"ring arena: the processes disagree on the "
                               f"ring call (phase, call, sizes {vals} here; "
                               f"max/min over the group {got})")

    def slot_ptr(self, base, slot, j, kind, region):
        """Region ``kind`` of member j's chunks in ``slot`` of the arena at
        ``base`` (slots are halves of the arena)."""
        return base + slot * (self.cap // 2) + (j * _KINDS + kind) * region

    def _drop(self, phase):
        """Free this process's arena once nothing reads it: this process's
        launches drained (its "done" events), a handshake, every peer's
        arena closed, a handshake (no importer left), the free."""
        for ev in self.done:
            self.ops.sync(ev)
        self._agree(phase, self.calls, self.cap)
        for ptr in self.peer_base.values():
            self.ops.close(self.device, ptr)
        self.peer_base = {}
        self._agree(phase, self.calls, self.cap)
        self.ops.free(self.device, self.base)
        self.base, self.cap = None, 0

    def _grow(self, need):
        if self.base is not None:
            self._drop(_GROW)
        self._agree(_GROW, self.calls, need)
        self.base, handle = self.ops.alloc(self.device, need)
        self.cap = need
        handles = self.ops.exchange(handle)
        for p, h in enumerate(handles):
            if p != self.me:
                self.peer_base[p] = self.ops.open(self.device, h)
                self.opened += 1

    def run(self, kinds, launch):
        """One call: ``kinds`` the call's input kinds in the table's order,
        each the list of this process's ranks' contiguous chunks (members
        order); ``launch(table)`` with ``table[kind][x]`` the pointer of
        ring position x's chunk."""
        region = max(t.numel() * t.element_size() for kind in kinds
                     for t in kind)
        region = -(-region // _ALIGN) * _ALIGN
        if 2 * self.k * _KINDS * region > self.cap:
            self._grow(2 * self.k * _KINDS * region)
        ops, slot = self.ops, self.calls % 2
        stream = ops.stream(self.device)
        for ev in [self.done[slot]] + [d[slot] for d in
                                       self.peer_done.values()]:
            ops.wait(stream, ev)
        for kind, ts in enumerate(kinds):
            for j, t in enumerate(ts):
                ops.copy(self.slot_ptr(self.base, slot, j, kind, region),
                         t, stream)
        ops.record(self.ready[slot], stream)
        t0 = time.perf_counter()
        self._agree(_CALL, self.calls, region, len(kinds))
        self.handshake_s += time.perf_counter() - t0
        self.handshakes += 1
        for ready in self.peer_ready.values():
            ops.wait(stream, ready[slot])
        table = [[None] * self.n for _ in kinds]
        for p, mem in enumerate(self.members):
            base = self.base if p == self.me else self.peer_base[p]
            for j, x in enumerate(mem):
                for kind in range(len(kinds)):
                    table[kind][x] = self.slot_ptr(base, slot, j, kind,
                                                   region)
        launch(table)
        ops.record(self.done[slot], stream)
        self.calls += 1

    def release(self):
        """Close the peers' arenas and free this one, in every process of
        the group together (the group must still be up)."""
        if self.base is not None:
            self._drop(_RELEASE)


# the arenas by (processes, members, device), in the order they were made
_ARENAS: dict = {}


def ring_arena(procs, members, me, device, pg) -> RingArena:
    """The arena of the ring whose positions ``members`` (per process, in
    the order of ``procs``) lie in the processes ``procs`` of the group
    ``pg``, on this process's card ``device``: made once, in every member
    process at the same call."""
    key = (tuple(procs), tuple(tuple(m) for m in members), int(device))
    if key not in _ARENAS:
        _ARENAS[key] = RingArena(members, me, device, _IpcOps(pg))
    return _ARENAS[key]


def release_ring_arenas() -> None:
    """Release every arena (``RingArena.release``), in the order they were
    made: every process of the rings calls it, before the group ends."""
    while _ARENAS:
        _ARENAS.pop(next(iter(_ARENAS))).release()


ring_fwd_cuda.launches = 0
ring_bwd_cuda.launches = 0


def _scores(q_r, k, r, src, Tl, H, causal, window, slopes, scale):
    """Rank r's float32 scores against the chunk of rank ``src``:
    scale q k^T plus the ALiBi bias, banned entries -inf."""
    s = scale * (q_r.float() @ k.float().transpose(-1, -2))
    i = torch.arange(Tl, device=q_r.device)
    rows = (r * Tl + i)[:, None]
    cols = (src * Tl + i)[None, :]
    if slopes is not None:
        sl = slopes.to(q_r.device).repeat(q_r.shape[0] // H)[:, None, None]
        s = s + sl * (cols - rows).float()
    ban = torch.zeros((Tl, Tl), dtype=torch.bool, device=q_r.device)
    if causal:
        ban |= cols > rows
    if window is not None:
        ban |= rows - cols >= window
    return torch.where(ban, float("-inf"), s)


@torch.no_grad()
def ring_fwd_step_ref(q, kv, m, l, acc, o, L, *, n: int, H: int, step: int,
                      ranks, causal: bool, window, slopes, scale: float,
                      last: bool):
    """One forward step the TPU's way, the plain version of K10: fold the
    chunks in the K/V slot ``kv`` (the n ranks' (2, BH, Tl, D)) into each
    rank's float32 running max ``m``, normalizer ``l`` (BH, Tl) and
    accumulator ``acc`` (BH, Tl, D), the same online softmax (-inf for
    banned scores), rank by rank; at the last step write o and L instead.
    Every argument is a list of the n ranks' rows, each rank's on its
    device; only those of ``ranks`` = (r0, nr) are read (the others may
    be None)."""
    Tl = q[ranks[0]].shape[1]
    ninf = float("-inf")
    for r in range(ranks[0], ranks[0] + ranks[1]):
        src = (r - step) % n
        live = chunk_live(src, r, Tl, causal, window)
        if not live and not last:
            continue
        if step == 0:
            m_r = torch.full_like(m[r], ninf)
            l_r = torch.zeros_like(l[r])
            acc_r = torch.zeros_like(acc[r])
        else:
            m_r, l_r, acc_r = m[r], l[r], acc[r]
        if live:
            s = _scores(q[r], kv[r][0], r, src, Tl, H, causal, window, slopes,
                        scale)
            mn = torch.maximum(m_r, s.amax(-1))
            none = mn == ninf  # nothing visible yet
            alpha = torch.where(none, 1.0, torch.exp(m_r - mn))
            p = torch.where(none[..., None], 0.0, torch.exp(s - mn[..., None]))
            l_r = l_r * alpha + p.sum(-1)
            acc_r = acc_r * alpha[..., None] + p @ kv[r][1].float()
            m_r = mn
        if last:
            denom = torch.where(l_r == 0, 1.0, l_r)
            o[r].copy_((acc_r / denom[..., None]).to(o[r].dtype))
            L[r].copy_(m_r + torch.log(denom))
        else:
            for x, val in ((m, m_r), (l, l_r), (acc, acc_r)):
                x[r].copy_(val)


@torch.no_grad()
def ring_bwd_step_ref(q, do, L, delta, bundle, dq_acc, dq, *, n: int,
                      H: int, step: int, ranks, causal: bool, window, slopes,
                      scale: float, last: bool):
    """One backward step the TPU's way, the plain version of K11: P
    recomputed from L, dq accumulated in float32 ``dq_acc`` (written to
    ``dq`` at the last step), the bundle slot's dk/dv gaining each rank's
    share of the chunk it holds. Per-rank lists as for
    ``ring_fwd_step_ref`` (``bundle``: the n ranks' (4, BH, Tl, D))."""
    Tl = q[ranks[0]].shape[1]
    for r in range(ranks[0], ranks[0] + ranks[1]):
        src = (r - step) % n
        live = chunk_live(src, r, Tl, causal, window)
        if not live and not last:
            continue
        acc_r = torch.zeros_like(dq_acc[r]) if step == 0 else dq_acc[r]
        if live:
            k, v = bundle[r][0], bundle[r][1]
            q_r, do_r = q[r].float(), do[r].float()
            s = _scores(q_r, k, r, src, Tl, H, causal, window, slopes, scale)
            p = torch.where(s == float("-inf"), 0.0,
                            torch.exp(s - L[r][..., None]))
            ds = (do_r @ v.transpose(-1, -2) - delta[r][..., None]) * p
            acc_r = acc_r + ds @ k
            bundle[r][2] += scale * (ds.transpose(-1, -2) @ q_r)
            bundle[r][3] += p.transpose(-1, -2) @ do_r
        if last:
            dq[r].copy_((scale * acc_r).to(dq[r].dtype))
        else:
            dq_acc[r].copy_(acc_r)
