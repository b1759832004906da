"""Port parity for the out-of-core route: edge-list IO, the two-pass dedup,
``stream_partition``, the on-disk ``StreamAssignment`` and the runtime
packed from it, against the JAX package on the CPU.

All of it is host numpy copied from the reference, so every check is
bitwise: arrays equal, shard files equal byte for byte, and the meta equal
on every key (it holds neither paths nor times).
"""
import dataclasses
import gzip

import numpy as np
import pytest

import repro.data as ref_data
import repro.data.io as ref_io
from repro.bsp import PartitionRuntime as RefRuntime
from repro.bsp import StreamAssignment as RefAssignment
from repro.core import AssignmentDelta as RefDelta
from repro.core import scaled_paper_cluster as ref_cluster
from repro.core.baselines import streaming as ref_s

import repro_torch.data as port_data
import repro_torch.data.io as port_io
from repro_torch.bsp import PartitionRuntime, StreamAssignment
from repro_torch.convert import RUNTIME_ARRAYS
from repro_torch.core import AssignmentDelta, scaled_paper_cluster
from repro_torch.core.baselines import streaming as port_s


def edge_file(tmp_path, name="edges.txt", scale=9, dups=True):
    """An R-MAT edge list with comments, reversed pairs, self loops and
    duplicates, written as text (``.gz`` by the name)."""
    g = ref_data.rmat(scale, seed=3)
    rows = g.edges
    if dups:
        rows = np.concatenate([rows, rows[::5, ::-1], rows[::7],
                               np.array([[5, 5], [0, 0]])])
    text = "# an edge list\n" + "".join(f"{u} {v}\n" for u, v in rows)
    path = tmp_path / name
    if name.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def blocks_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["edges.txt", "edges.txt.gz"])
def test_read_and_write_edge_list(tmp_path, name):
    path = edge_file(tmp_path, name)
    a, b = ref_data.read_edge_list(path), port_data.read_edge_list(path)
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(a.edges, b.edges)
    out = name.replace("edges", "out")
    ref_data.write_edge_list(a, str(tmp_path / f"ref_{out}"))
    port_data.write_edge_list(b, str(tmp_path / f"port_{out}"))
    read = (gzip.open if name.endswith(".gz") else open)
    with read(tmp_path / f"ref_{out}", "rb") as f, \
            read(tmp_path / f"port_{out}", "rb") as h:
        assert f.read() == h.read()


@pytest.mark.parametrize("block_size", [1, 97, 65536])
def test_block_iteration_and_counts(tmp_path, block_size):
    path = edge_file(tmp_path)
    for canonicalize in (True, False):
        blocks_equal(ref_io.iter_edge_blocks(path, block_size,
                                             canonicalize=canonicalize),
                     port_io.iter_edge_blocks(path, block_size,
                                              canonicalize=canonicalize))
    assert ref_io.count_edge_list(path, block_size) == \
        port_io.count_edge_list(path, block_size)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_byte_ranges_and_range_iteration(tmp_path, n):
    path = edge_file(tmp_path)
    ranges = ref_io.byte_ranges(path, n)
    assert port_io.byte_ranges(path, n) == ranges
    for start, end in ranges:
        blocks_equal(ref_io.iter_edge_blocks_range(path, start, end, 50),
                     port_io.iter_edge_blocks_range(path, start, end, 50))


def test_canonicalize_block():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 40, size=(500, 2))
    for dedup in (True, False):
        np.testing.assert_array_equal(
            ref_io.canonicalize_block(rows, dedup),
            port_io.canonicalize_block(rows, dedup))


@pytest.mark.parametrize("name", ["edges.txt", "edges.txt.gz"])
def test_two_pass_dedup_and_spill_stats(tmp_path, name):
    path = edge_file(tmp_path, name)
    kw = dict(block_size=300, bucket_rows=700, merge_rows=128)
    with ref_io.TwoPassDedup(path, str(tmp_path / "ref_spill"), **kw) as a, \
            port_io.TwoPassDedup(path, str(tmp_path / "port_spill"),
                                 **kw) as b:
        assert a.prepare() == b.prepare()
        blocks_equal(a, b)
        sa, sb = dataclasses.asdict(a.stats), dataclasses.asdict(b.stats)
        assert sa == sb and a.stats.num_buckets > 1
        assert a.stats.duplicate_rows == b.stats.duplicate_rows > 0
    a = ref_data.two_pass_dedup(path)
    b = port_data.two_pass_dedup(path)
    blocks_equal(a, b)
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    a.close()
    b.close()


def clusters(path):
    _, num_e = ref_io.count_edge_list(path)
    return (ref_cluster(2, 4, num_e, slack=2.0),
            scaled_paper_cluster(2, 4, num_e, slack=2.0))


def states_equal(a, b):
    for f in ("cnt", "edges_per", "verts_per"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    if a.spill_stats is None:
        assert b.spill_stats is None
    else:
        assert dataclasses.asdict(a.spill_stats) == \
            dataclasses.asdict(b.spill_stats)


@pytest.mark.parametrize("dedup", ["block", "two_pass"])
@pytest.mark.parametrize("method", ["greedy", "hdrf", "ebv"])
def test_stream_partition_states(tmp_path, method, dedup):
    path = edge_file(tmp_path)
    cl_ref, cl = clusters(path)
    kw = dict(method=method, dedup=dedup, block_size=256)
    states_equal(ref_s.stream_partition(path, cluster=cl_ref, **kw),
                 port_s.stream_partition(path, cluster=cl, **kw))


def stream_to_disk(tmp_path, method="hdrf", dedup="two_pass"):
    """The same stream through both packages into two assignment dirs."""
    path = edge_file(tmp_path)
    cl_ref, cl = clusters(path)
    num_v, _ = ref_io.count_edge_list(path)
    out = []
    for pkg, klass, c, tag in ((ref_s, RefAssignment, cl_ref, "ref"),
                               (port_s, StreamAssignment, cl, "port")):
        sa = klass(tmp_path / tag, c.p, num_v)
        state = pkg.stream_partition(path, cluster=c, method=method,
                                     dedup=dedup, block_size=256,
                                     sink=sa.sink)
        sa.finalize(state, {"method": method, "dedup": dedup})
        out.append((state, sa))
    return out


def assignments_equal(a, b):
    assert a.meta == b.meta
    names = sorted(f.name for f in a.dir.iterdir()
                   if f.name.startswith("shard"))
    assert names == sorted(f.name for f in b.dir.iterdir()
                           if f.name.startswith("shard"))
    for name in names:
        assert (a.dir / name).read_bytes() == (b.dir / name).read_bytes()
    with np.load(a.dir / "state.npz") as x, np.load(b.dir / "state.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    np.testing.assert_array_equal(a.membership(), b.membership())
    np.testing.assert_array_equal(a.degree, b.degree)
    for i in range(a.p):
        np.testing.assert_array_equal(a.machine_edges(i), b.machine_edges(i))


@pytest.mark.parametrize("dedup", ["block", "two_pass"])
def test_stream_assignment_shards_and_meta(tmp_path, dedup):
    (s_ref, a), (s, b) = stream_to_disk(tmp_path, dedup=dedup)
    states_equal(s_ref, s)
    assignments_equal(a, b)
    assignments_equal(RefAssignment.open(a.dir), StreamAssignment.open(b.dir))
    assert a.replication_factor() == b.replication_factor()


def test_compact_folds_tombstones_as_the_reference(tmp_path):
    """Tombstone every 10th row of machine 0's shard (few enough to stay
    below the automatic rewrite), then compact both assignments."""
    (state, a), (_, b) = stream_to_disk(tmp_path)
    rows = a.machine_edges(0)[::10].astype(np.int64)
    degree = a.degree.copy()
    np.subtract.at(degree, rows.ravel(), 1)
    member = (state.cnt > 0).copy()
    member[:, degree == 0] = False
    empty = (np.empty((0, 2), dtype=np.int64), np.empty(0, dtype=np.int64))
    for sa, klass in ((a, RefDelta), (b, AssignmentDelta)):
        sa.apply_delta(klass(num_vertices=sa.num_vertices, added=empty[0],
                             added_ms=empty[1], removed=rows,
                             removed_ms=np.zeros(len(rows), dtype=np.int64)),
                       member, {"method": "hdrf"})
        assert sa.tomb_rows[0] > 0
    assignments_equal(a, b)
    for frac in (1.0, 0.0):         # a no-op above the threshold, then fold
        assert a.compact(frac) == b.compact(frac)
        assignments_equal(a, b)
    assert b.tomb_rows.sum() == 0


def runtimes_equal(a, b):
    for f in ("p", "num_vertices", "num_replicas") + RUNTIME_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_from_stream_runtime_fields(tmp_path):
    (_, a), (_, b) = stream_to_disk(tmp_path)
    rt_ref = RefRuntime.from_stream(a)
    runtimes_equal(rt_ref, PartitionRuntime.from_stream(b, device="cpu"))
    runtimes_equal(rt_ref, PartitionRuntime.create(str(b.dir),
                                                   device="cpu"))

    def weights(edges, i):
        return (edges[:, 0] % 3 + 1 + i).astype(np.float32)
    runtimes_equal(RefRuntime.from_stream(a, edge_weights=weights),
                   PartitionRuntime.from_stream(b, edge_weights=weights,
                                                device="cpu"))


def test_stream_route_rejects_graph_keywords(tmp_path):
    (_, _), (_, b) = stream_to_disk(tmp_path)
    with pytest.raises(ValueError, match="edge_weights"):
        PartitionRuntime.create(b, p=b.p, device="cpu")
