"""The ring kernels across processes (``kernels.ring_attention.RingArena``,
CUDA IPC): the arena's protocol on the CPU with its CUDA and group calls
replaced by a recorder, and, on a card, two processes that share it.

Imports neither JAX nor ``linalg_tpu``, so it also runs on a machine with
a card and no JAX (``python -m pytest tests/test_torch_ring_ipc.py -q -m
cuda --noconftest``). Run as a script (``URL RANK OUT_DIR``) it is one of
the card test's two processes.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from linalg_tpu_torch.kernels import ring_attention as kr

REPO = pathlib.Path(__file__).resolve().parents[1]


class FakeEvent:
    def __init__(self, name):
        self.name = name


class FakeOps:
    """Process ``me`` of ``nproc``: every call logged; a peer's handles and
    pointers are made up from its index, as the exchange would bring
    them."""

    def __init__(self, me, nproc):
        self.me, self.nproc = me, nproc
        self.log = []
        self.allocs = 0
        self.peer_ptrs = {}

    def alloc(self, device, nbytes):
        self.allocs += 1
        self.log.append(("alloc", nbytes))
        return (self.me + 1) << 32 | self.allocs << 24, \
            f"p{self.me}:mem{self.allocs}".encode()

    def open(self, device, handle):
        self.log.append(("open", handle))
        p, k = handle.decode().split(":mem")
        ptr = (int(p[1:]) + 1) << 32 | int(k) << 24
        self.peer_ptrs[handle] = ptr
        return ptr

    def close(self, device, ptr):
        self.log.append(("close", ptr))

    def free(self, device, ptr):
        self.log.append(("free", ptr))

    def copy(self, dst, src, stream):
        self.log.append(("copy", dst, src.numel() * src.element_size()))

    def stream(self, device):
        return "stream"

    def event(self, device):
        i = sum(e[0] == "event" for e in self.log)
        self.log.append(("event", i))
        name = f"p{self.me}:{('ready', 'ready', 'done', 'done')[i]}{i % 2}"
        return FakeEvent(name), name.encode()

    def open_event(self, device, handle):
        return FakeEvent(handle.decode())

    def record(self, ev, stream):
        self.log.append(("record", ev.name))

    def wait(self, stream, ev):
        self.log.append(("wait", ev.name))

    def sync(self, ev):
        self.log.append(("sync", ev.name))

    def exchange(self, obj):
        self.log.append(("exchange",))

        def as_peer(x, p):
            if isinstance(x, list):
                return [as_peer(y, p) for y in x]
            return x.replace(f"p{self.me}:".encode(), f"p{p}:".encode())
        return [obj if p == self.me else as_peer(obj, p)
                for p in range(self.nproc)]

    def handshake(self, vec):
        self.log.append(("handshake", tuple(vec)))
        return list(vec)


def chunks(m, BH=4, Tl=8, D=32, kinds=3):
    return [[torch.zeros(BH, Tl, D) for _ in range(m)] for _ in range(kinds)]


def arena(members, me):
    ops = FakeOps(me, len(members))
    return kr.RingArena(members, me, 0, ops), ops


def run(a, kinds):
    """One call; the launch logs itself and hands back the table."""
    tables = []

    def launch(table):
        a.ops.log.append(("launch",))
        tables.append(table)

    a.run(kinds, launch)
    return tables[0]


def test_each_peer_handle_opened_once_never_its_own():
    a, ops = arena([[0], [1], [2]], 1)
    for _ in range(4):
        run(a, chunks(1))
    opened = [e[1] for e in ops.log if e[0] == "open"]
    assert opened == [b"p0:mem1", b"p2:mem1"] and a.opened == 2
    assert [e for e in ops.log if e[0] == "alloc"] == [
        ("alloc", 2 * 1 * 6 * 4 * 8 * 32 * 4)]
    # the events: this process's four made, each peer's four opened once
    assert sorted(a.peer_ready) == [0, 2]
    assert [e.name for e in a.peer_done[2]] == ["p2:done0", "p2:done1"]


def test_table_holds_own_slots_for_own_ranks():
    a, ops = arena([[0, 1], [2, 3]], 0)
    region = 4 * 8 * 32 * 4
    for call in range(3):
        table = run(a, chunks(2))
        slot = call % 2
        half = a.cap // 2
        assert a.cap == 2 * 2 * 6 * region
        for kind in range(3):
            for j, x in enumerate((0, 1)):
                assert table[kind][x] == a.base + slot * half + (
                    j * 6 + kind) * region
            for j, x in enumerate((2, 3)):
                assert table[kind][x] == a.peer_base[1] + slot * half + (
                    j * 6 + kind) * region
        copies = [e for e in ops.log if e[0] == "copy"][-6:]
        assert [e[1] for e in copies] == [
            table[kind][x] for kind in range(3) for x in (0, 1)]


def test_each_call_keeps_the_order_with_double_buffer_waits():
    a, ops = arena([[0, 1], [2, 3]], 1)
    run(a, chunks(2))
    for call in range(1, 4):
        ops.log.clear()
        run(a, chunks(2, kinds=6))
        s = call % 2
        region = 4 * 8 * 32 * 4
        want = ([("wait", f"p1:done{s}"), ("wait", f"p0:done{s}")]
                + [("copy",)] * 12 + [("record", f"p1:ready{s}"),
                                      ("handshake", (1, -1, call, -call,
                                                     region, -region, 6,
                                                     -6)),
                                      ("wait", f"p0:ready{s}"), ("launch",)]
                + [("record", f"p1:done{s}")])
        got = [e[:1] if e[0] == "copy" else e for e in ops.log]
        assert got == want, call


def test_growth_swaps_the_handles_again():
    a, ops = arena([[0], [1]], 0)
    run(a, chunks(1))
    old, old_peer = a.base, a.peer_base[1]
    ops.log.clear()
    run(a, chunks(1, D=64))
    grow = ops.log[:ops.log.index(("exchange",)) + 2]
    cap, need = 2 * 6 * 4 * 8 * 32 * 4, 2 * 6 * 4 * 8 * 64 * 4
    assert grow == [
        ("sync", "p0:done0"), ("sync", "p0:done1"),
        ("handshake", (2, -2, 1, -1, cap, -cap)), ("close", old_peer),
        ("handshake", (2, -2, 1, -1, cap, -cap)), ("free", old),
        ("handshake", (2, -2, 1, -1, need, -need)), ("alloc", need),
        ("exchange",), ("open", b"p1:mem2")]
    assert a.base != old and a.peer_base[1] != old_peer and a.opened == 2
    run(a, chunks(1))  # smaller again: no growth
    assert a.opened == 2 and a.cap == need


def test_release_closes_before_the_owner_frees():
    a, ops = arena([[0], [1]], 1)
    run(a, chunks(1))
    base, peer = a.base, a.peer_base[0]
    ops.log.clear()
    a.release()
    assert [e[0] for e in ops.log] == ["sync", "sync", "handshake", "close",
                                       "handshake", "free"]
    assert ops.log[3] == ("close", peer) and ops.log[5] == ("free", base)
    assert a.base is None and a.peer_base == {}
    a.release()  # a released arena has nothing left to free
    assert len(ops.log) == 6


def test_disagreeing_processes_raise():
    a, ops = arena([[0], [1]], 0)
    ops.handshake = lambda vec: [v + 1 for v in vec]
    with pytest.raises(RuntimeError, match="disagree"):
        run(a, chunks(1))


def test_c_entry_point_failures_raise(monkeypatch):
    """The arena's CUDA calls through the library raise on a failure code:
    a handle that does not open (a peer without access) names it."""
    class Lib:
        def ring_ipc_open(self, dev, handle, ptr):
            return 201

        def ring_ipc_close(self, dev, ptr):
            return 1

        def ring_ipc_handle_bytes(self):
            return 64

        def ring_ipc_alloc(self, dev, nbytes, ptr, handle):
            return 2

    monkeypatch.setattr(kr, "_lib", Lib)
    ops = kr._IpcOps(None)
    with pytest.raises(RuntimeError, match="peer access"):
        ops.open(0, b"x" * 64)
    with pytest.raises(RuntimeError, match="cudaIpcCloseMemHandle"):
        ops.close(0, 1)
    with pytest.raises(RuntimeError, match="cudaMalloc"):
        ops.alloc(0, 1024)


def test_arenas_are_made_once_a_ring_and_released_in_order(monkeypatch):
    made = []

    class Ops:
        def __init__(self, pg):
            made.append(pg)

    class Arena:
        def __init__(self, members, me, device, ops):
            self.members = members

        def release(self):
            made.append(("released", self.members))

    monkeypatch.setattr(kr, "_IpcOps", Ops)
    monkeypatch.setattr(kr, "RingArena", Arena)
    monkeypatch.setattr(kr, "_ARENAS", {})
    a = kr.ring_arena((0, 1), [[0, 1], [2, 3]], 0, 0, "pg")
    assert kr.ring_arena((0, 1), [[0, 1], [2, 3]], 0, 0, "pg") is a
    kr.ring_arena((0, 1), [[0], [1]], 0, 0, "pg")
    kr.release_ring_arenas()
    assert made == ["pg", "pg", ("released", [[0, 1], [2, 3]]),
                    ("released", [[0], [1]])]
    assert kr._ARENAS == {}


# -- on the card: two processes --------------------------------------------

B, H, T, D = 2, 4, 512, 64


def child(url, rank, out_dir):
    """One of the card test's processes: the per-rank kernel ring over a
    (1, 4) mesh, two ranks a process on the one card, against the same
    ring in this process alone on views of the global tensors."""
    from linalg_tpu_torch.parallel import (init_distributed, make_mesh,
                                           make_ring_attention_pallas)
    from linalg_tpu_torch.parallel.mesh import taped
    from linalg_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_ranks)

    rank = int(rank)
    assert init_distributed(url, 2, rank, backend="gloo", timeout_s=120)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, w = (torch.randn(B, H, T, D, device="cuda", dtype=dtype,
                                  generator=g) for _ in range(4))
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        one = make_ring_attention_pallas(make_mesh((1, 4), ("dp", "sp"),
                                                   ["cuda"] * 4), window=200)
        o = one(*xs)
        want = [o] + list(torch.autograd.grad(o, xs, w))
        mesh = make_mesh((1, 4), ("dp", "sp"), device_type="cuda")
        Tl = T // 4
        cut = [[x[:, :, r * Tl:(r + 1) * Tl].clone().requires_grad_(True)
                if mesh.is_local(r) else None for r in range(4)]
               for x in (q, k, v)]
        for c in (kr.ring_fwd_cuda, kr.ring_bwd_cuda):
            c.launches = 0
        with taped() as tape:
            outs = ring_attention_pallas_ranks(*cut, mesh, window=200)
            loss = tape.tie(sum((outs[r] * w[:, :, r * Tl:(r + 1) * Tl])
                                .float().sum() for r in mesh.local_ranks))
        mine = [x[r] for x in cut for r in mesh.local_ranks]
        grads = torch.autograd.grad(loss, mine + [tape.root])
        m = len(mesh.local_ranks)
        same = []
        for i, r in enumerate(mesh.local_ranks):
            rows = slice(r * Tl, (r + 1) * Tl)
            same.append(torch.equal(outs[r], want[0][:, :, rows]))
            same += [torch.equal(grads[j * m + i], want[1 + j][:, :, rows])
                     for j in range(3)]
        res[str(dtype)] = dict(same=same, launches=[
            kr.ring_fwd_cuda.launches, kr.ring_bwd_cuda.launches])
    kr.release_ring_arenas()
    (pathlib.Path(out_dir) / f"ipc{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.mark.cuda
def test_two_processes_on_one_card_equal_one_process(tmp_path):
    """K10/K11 with two ranks in each of two processes on the card, each
    reading the other's chunks through CUDA IPC: outputs and gradients bit
    for bit those of the same ring in one process, one launch a process and
    direction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "LOCAL_WORLD_SIZE"))}
    env.update(PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               LOCAL_WORLD_SIZE="2")
    url = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen([sys.executable, __file__, url, str(r),
                               str(tmp_path)], env=dict(env,
                                                        LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    for r in (0, 1):
        res = json.loads((tmp_path / f"ipc{r}.json").read_text())
        for dtype, got in res.items():
            assert all(got["same"]), (r, dtype, got)
            assert got["launches"] == [1, 1], (r, dtype, got)


if __name__ == "__main__":
    child(*sys.argv[1:4])
