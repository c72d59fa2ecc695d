"""The port's remaining comm verbs (``comm/comm.py``: ``reduce``,
``send_recv``, ``send_next``, ``send_prev``, ``gather``, ``scatter``,
``monitored_barrier``, ``all_reduce_coalesced``, ``all_gather_coalesced``,
``isend``, ``irecv``) against the JAX package's, on 4 gloo ranks of
``tests/test_torch_comm_worker.py``.

Mirrors ``tests/test_comm.py``'s ring, host-level and verb cases (not the
comms logger, ROADMAP A15): each verb's result on every rank is the JAX
verb's under ``shard_map`` over 4 CPU devices on the same inputs, computed
here, exactly (the values are small integers).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu.comm as jdist
from deepspeed_tpu_torch.comm import comm as dist

WORLD = 4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_comm_worker.py")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_comm")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(d / "rdzv"),
                               str(d / f"out{r}.pt")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env) for r in range(WORLD)]
    logs = [p.communicate(timeout=90)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        if p.returncode:
            pytest.fail(f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}")
    return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)]


def smap(fn, in_specs, out_specs, *args):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))(*args)


def rows(got, key):
    return np.stack([np.asarray(r[key]) for r in got])


def test_send_next_ring_and_point_to_point(ranks):
    x = jnp.arange(float(WORLD))
    want = smap(lambda v: (jdist.send_next(v, axis_name="dp"),
                           jdist.send_prev(v, axis_name="dp"),
                           jdist.send_recv(v, [(0, 2), (2, 0)], axis_name="dp")),
                P("dp"), (P("dp"), P("dp"), P("dp")), x)
    for key, w in zip(("send_next", "send_prev", "send_recv"), want):
        np.testing.assert_array_equal(rows(ranks, key).reshape(-1), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(want[0]), np.roll(np.arange(4.0), 1))


def test_host_level_api(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert all(r["world"] == WORLD for r in ranks)
    # one process, no group: the verbs return what a one-device axis does
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
    dist.barrier()
    dist.monitored_barrier()
    x = torch.arange(3.0)
    assert torch.equal(dist.send_next(x), x) and torch.equal(dist.reduce(x.clone()), x)
    assert torch.equal(dist.gather(x), x[None])


def test_coalesced_and_scatter_gather_verbs(ranks):
    """``tests/test_comm.py``'s verb case, on every rank."""
    a = jnp.arange(8.0).reshape(4, 2)
    b = jnp.arange(4.0)

    def body(x, y):
        g = jdist.gather(x, axis_name="dp")
        summed = jdist.all_reduce_coalesced([x, y], axis_name="dp")
        st = jdist.scatter(jnp.ravel(g) * 0 + jnp.arange(8.0), axis_name="dp")
        ag = jdist.all_gather_coalesced([x, y], axis_name="dp")
        h = jdist.isend(x, dst=1, src=0, axis_name="dp")
        r = jdist.irecv(x, src=3, dst=2, axis_name="dp")
        red = jdist.reduce(y, dst=1, axis_name="dp")
        return g, summed[0], summed[1], st, ag[0], ag[1], h.wait(), r.wait(), red

    g, s0, s1, st, ag0, ag1, snt, rcv, red = smap(
        body, (P("dp"), P("dp")), (P(), P("dp"), P("dp"), P("dp"), P(), P(), P("dp"),
                                   P("dp"), P("dp")), a, b)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gather"].numpy(), np.asarray(g))
        np.testing.assert_array_equal(got["all_reduce_coalesced"][0].numpy(),
                                      np.asarray(s0)[r:r + 1])
        np.testing.assert_array_equal(got["all_reduce_coalesced"][1].numpy(),
                                      np.asarray(s1)[r:r + 1])
        np.testing.assert_array_equal(got["scatter"].numpy(), np.asarray(st)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["all_gather_coalesced"][0].numpy(), np.asarray(ag0))
        np.testing.assert_array_equal(got["all_gather_coalesced"][1].numpy(), np.asarray(ag1))
        np.testing.assert_array_equal(got["isend"].numpy(), np.asarray(snt)[r:r + 1])
        np.testing.assert_array_equal(got["irecv"].numpy(), np.asarray(rcv)[r:r + 1])
        np.testing.assert_array_equal(got["reduce"].numpy(), np.asarray(red)[r:r + 1])
    np.testing.assert_array_equal(ranks[1]["isend"].numpy(), np.asarray(a)[0:1])
    np.testing.assert_array_equal(ranks[0]["isend"].numpy(), np.zeros((1, 2)))


def test_coalesced_mixed_dtypes_preserved(ranks):
    for got in ranks:
        r0, r1 = got["mixed_reduce"]
        g0, g1 = got["mixed_gather"]
        assert r0.dtype == torch.bfloat16 and g0.dtype == torch.bfloat16
        assert r1.dtype == torch.float32 and g1.dtype == torch.float32
        assert torch.all(r1 == 4.0) and torch.all(r0 == 4.0)
        assert g0.shape == (WORLD, 1, 2) and g1.shape == (WORLD, 1, 3)
