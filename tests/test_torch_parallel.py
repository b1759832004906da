"""Port parity for the multi-process partition pipeline
(``core/parallel.py``): the sharded two-pass dedup and
``parallel_stream_partition`` at ``sync_blocks=1``, against the JAX
package and against the port's own sequential path, bitwise.

The pipeline forks worker processes.  A fork that wedges would hang the
run rather than fail it, so every test here runs under a time limit of its
own (``LIMIT_S``, a SIGALRM that raises in the test).
"""
import signal

import numpy as np
import pytest

from repro.bsp import StreamAssignment as RefAssignment
from repro.core import scaled_paper_cluster as ref_cluster
from repro.core.baselines import streaming as ref_s
from repro.core.parallel import ShardedTwoPassDedup as RefSharded
from repro.core.parallel import parallel_stream_partition as ref_parallel
from repro.data import rmat

from repro_torch.bsp import StreamAssignment
from repro_torch.core import scaled_paper_cluster
from repro_torch.core.baselines import streaming as port_s
from repro_torch.core.parallel import ShardedTwoPassDedup
from repro_torch.core.parallel import parallel_stream_partition
from repro_torch.data import TwoPassDedup

#: seconds each test may take; every one takes a few on one CPU core
LIMIT_S = 60


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {LIMIT_S} s limit")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def edge_file(tmp_path, gz=False):
    """An R-MAT edge list with duplicates injected, as text."""
    g = rmat(9, edge_factor=6, seed=3)
    rows = np.concatenate([g.edges, g.edges[::5], g.edges[::3, ::-1]])
    path = tmp_path / ("edges.txt.gz" if gz else "edges.txt")
    text = "# dups\n" + "".join(f"{u} {v}\n" for u, v in rows)
    if gz:
        import gzip
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path), g.num_edges


def blocks(source):
    return [b.copy() for b in source]


@pytest.mark.parametrize("gz", [False, True], ids=["text", "gzip"])
def test_sharded_dedup_equals_reference_and_sequential(tmp_path, gz):
    path, _ = edge_file(tmp_path, gz)
    kw = dict(block_size=64, bucket_rows=128)
    with RefSharded(path, workers=2, **kw) as a, \
            ShardedTwoPassDedup(path, workers=2, **kw) as b, \
            TwoPassDedup(path, **kw) as seq:
        assert a.prepare() == b.prepare() == seq.prepare()
        got = blocks(b)
        for want in (blocks(a), blocks(seq)):
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
        assert vars(a.stats) == vars(b.stats)
        assert b.stats.workers == 2
        assert b.stats.unique_edges == seq.stats.unique_edges


def states_equal(a, b):
    for f in ("cnt", "edges_per", "verts_per"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def shard_bytes(sa):
    return [(sa.dir / f"shard{i}.edges").read_bytes() for i in range(sa.p)]


@pytest.mark.parametrize("method", ["hdrf", "greedy", "ebv"])
def test_parallel_stream_partition_sync1(tmp_path, method):
    """Two workers synced every engine block: the reference's result and
    the port's sequential one, membership and shard bytes included."""
    path, num_e = edge_file(tmp_path)
    kw = dict(method=method, dedup="two_pass", block_size=256)
    runs = {}
    for tag, fn, klass, cluster in (
            ("ref", ref_parallel, RefAssignment, ref_cluster),
            ("port", parallel_stream_partition, StreamAssignment,
             scaled_paper_cluster),
            ("seq", port_s.stream_partition, StreamAssignment,
             scaled_paper_cluster)):
        cl = cluster(2, 4, num_e, slack=2.0)
        with TwoPassDedup(path) as tp:
            tp.prepare()
            sa = klass(tmp_path / tag, cl.p, tp.num_vertices)
        par = {} if tag == "seq" else dict(workers=2, sync_blocks=1)
        state = fn(path, cluster=cl, sink=sa.sink, **kw, **par)
        sa.finalize(state, {"method": method})
        runs[tag] = (state, sa)
    for other in ("ref", "seq"):
        states_equal(runs["port"][0], runs[other][0])
        assert shard_bytes(runs["port"][1]) == shard_bytes(runs[other][1])
        assert runs["port"][1].meta == runs[other][1].meta


def test_stream_partition_hands_workers_to_the_pipeline(tmp_path):
    """``stream_partition(workers=2)`` is the reference's call, bitwise."""
    path, num_e = edge_file(tmp_path)
    kw = dict(method="hdrf", dedup="block", block_size=128, workers=2,
              sync_blocks=1)
    states_equal(
        ref_s.stream_partition(path, cluster=ref_cluster(2, 4, num_e),
                               **kw),
        port_s.stream_partition(path, cluster=scaled_paper_cluster(
            2, 4, num_e), **kw))
