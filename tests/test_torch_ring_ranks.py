"""K10/K11's ranks on devices of their own, on the CPU: each rank's rows a
tensor of its own on its rank's device, through the plain versions, against
the ranks' views of the inputs (the one-device layout) and against the JAX
package's ``make_ring_attention_pallas`` (its Pallas ring in interpret
mode) on (4,) and (2, 4) meshes, as tests/test_torch_ring.py holds the
one-device layout.

On the CPU every rank's device is ``cpu``, so the tests patch
``_ring_size`` to hand the ranks "their" devices: they hold the
bookkeeping (the rows each rank takes, the two K/V slot lists and the
bundle lap, the rotation between ranks, the gather back), not a transport
between cards. The card runs the kernel through the same tables
(``tests/test_torch_kernels.py``, ``cuda`` marker). How meshes on several
devices become rings is checked on device names alone.
"""

import pytest
import torch

from linalg_tpu.parallel import make_ring_attention_pallas as jring_pallas
from linalg_tpu_torch.parallel import make_mesh, make_ring_attention_pallas
from linalg_tpu_torch.parallel.ring_pallas import (
    _ring_size, ring_attention_pallas_bwd_local, ring_attention_pallas_local)
from test_torch_ring import (CASES, assert_close, jax_mesh, jax_out_grads,
                             port_mesh, port_out_grads, qkvw)

torch.set_num_threads(2)

CPU = torch.device("cpu")


def own_devices(monkeypatch, rings=1):
    """Give every rank tensors of its own on the CPU, in ``rings`` rings
    (the batch split over them)."""
    from linalg_tpu_torch.parallel import ring_pallas

    monkeypatch.setattr(ring_pallas, "_ring_size", lambda mesh, axis, dev: (
        mesh.shape[axis], [[CPU] * mesh.shape[axis]] * rings))


def local_both(arrs, mesh, **kw):
    """(o, L, dq, dk, dv) of the local functions in float64."""
    q, k, v, do = (torch.tensor(a, dtype=torch.float64) for a in arrs)
    o, L = ring_attention_pallas_local(q, k, v, mesh=mesh, with_lse=True,
                                       **kw)
    delta = torch.sum(do * o, dim=-1)
    return (o, L) + ring_attention_pallas_bwd_local(
        q, k, v, do, L, delta, mesh=mesh, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", [(4,), (2, 4)], ids=["n4", "dp2_sp4"])
def test_rank_lists_equal_stacked(shape, name, monkeypatch):
    """Ranks with tensors of their own take the steps of ranks that read
    views of the inputs, in the same order: the same bits."""
    arrs = qkvw(B=4, seed=30 + len(shape))
    mesh = port_mesh(shape)
    stacked = local_both(arrs, mesh, **CASES[name])
    own_devices(monkeypatch)
    ranks = local_both(arrs, mesh, **CASES[name])
    for what, a, b in zip(("o", "L", "dq", "dk", "dv"), ranks, stacked):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_lists_match_jax_pallas_ring(name, monkeypatch):
    arrs = qkvw(seed=40)
    want = jax_out_grads(jring_pallas(jax_mesh((4,)), **CASES[name]), arrs)
    own_devices(monkeypatch)
    got = port_out_grads(make_ring_attention_pallas(
        port_mesh((4,)), **CASES[name]), arrs)
    assert_close(got, want)


def test_rank_lists_dp_x_sp_match_jax(monkeypatch):
    arrs = qkvw(seed=41)
    want = jax_out_grads(jring_pallas(jax_mesh((2, 4)), batch_axis="dp",
                                      window=12), arrs)
    own_devices(monkeypatch)
    got = port_out_grads(make_ring_attention_pallas(
        port_mesh((2, 4)), batch_axis="dp", window=12), arrs)
    assert_close(got, want)


def test_meshes_over_devices_become_rings():
    """Ranks on the inputs' device read views of them; ranks on other
    devices form one ring when every group lies on the same devices, else
    one ring per group (the batch split over them)."""
    assert _ring_size(port_mesh((2, 4)), "sp", CPU) == (4, None)
    two = ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]
    n, rings = _ring_size(make_mesh((4,), ("sp",), two), "sp", CPU)
    assert n == 4 and rings == [[torch.device(d) for d in two]]
    n, rings = _ring_size(make_mesh((2, 4), ("dp", "sp"), two * 2), "sp",
                          CPU)
    assert rings == [[torch.device(d) for d in two]]
    eight = [f"cuda:{i}" for i in range(8)]
    n, rings = _ring_size(make_mesh((2, 4), ("dp", "sp"), eight), "sp",
                          torch.device("cuda", 0))
    assert rings == [[torch.device(d) for d in eight[:4]],
                     [torch.device(d) for d in eight[4:]]]
    # CPU tensors cannot ride a ring of cards
    attn = make_ring_attention_pallas(make_mesh((4,), ("sp",), two))
    q = torch.zeros(1, 1, 32, 8)
    with pytest.raises(ValueError, match="ring ranks on"):
        attn(q, q, q)


def test_batch_blocks_ride_their_rings(monkeypatch):
    """A dp x sp mesh whose groups lie on different devices gives one ring
    a group: the batch's blocks go to their rings in group order and come
    back in place (two rings of CPU ranks stand in for two groups of
    cards)."""
    arrs = qkvw(B=4, seed=42)
    mesh = port_mesh((2, 4))
    want = local_both(arrs, mesh, window=12)
    own_devices(monkeypatch, rings=2)
    got = local_both(arrs, mesh, window=12)
    for what, a, b in zip(("o", "L", "dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), what
