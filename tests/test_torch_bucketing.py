"""Port parity: ``repro_torch.comms.bucketing`` against the reference.

Tolerance: exact -- layouts are integer index math, and stack/unstack only
move values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import bucketing as jb
from repro_torch.comms import bucketing as tb


@pytest.mark.parametrize("total,bucket_bytes,chunk", [
    (3 * 4096 + 517, 4096 * 4, 4096),
    (10 * 4096, 2 * 4096 * 4, 4096),
    (4096 * 7 + 100, None, 4096),
    (1000, 64, 128),
    (901_271_808, 64 << 20, 4096),
])
def test_layout_field_for_field(total, bucket_bytes, chunk):
    jl = jb.build_layout(total, bucket_bytes, chunk)
    tl = tb.build_layout(total, bucket_bytes, chunk)
    assert (tl.total, tl.boundaries, tl.chunk) == (jl.total, jl.boundaries, jl.chunk)
    assert tl.sizes() == jl.sizes()
    assert tl.chunk_counts() == jl.chunk_counts()
    assert (tl.max_chunks, tl.padded_size, tl.uniform) == (jl.max_chunks, jl.padded_size,
                                                            jl.uniform)


def test_full_width_layout_rows():
    """gemma2_2b at 4 layers, 64 MB buckets: 54 buckets x 4096 chunk rows."""
    tl = tb.build_layout(901_271_808, 64 << 20, 4096)
    assert (tl.n_buckets, tl.max_chunks) == (54, 4096)


@pytest.mark.parametrize("total,bucket_bytes", [(3 * 4096 + 517, 4096 * 4), (8 * 4096, 8192)])
def test_stack_unstack_equal(total, bucket_bytes):
    flat = np.random.default_rng(0).standard_normal(total).astype(np.float32)
    jl = jb.build_layout(total, bucket_bytes)
    tl = tb.build_layout(total, bucket_bytes)
    js = np.asarray(jb.stack_buckets(jnp.asarray(flat), jl))
    ts = tb.stack_buckets(torch.from_numpy(flat), tl)
    np.testing.assert_array_equal(js, ts.numpy())
    np.testing.assert_array_equal(tb.unstack_buckets(ts, tl).numpy(), flat)


@pytest.mark.parametrize("total,bucket_bytes", [(3 * 4096 + 517, 4096 * 4), (4096 * 7, None)])
def test_split_and_concat_buckets_match_reference(total, bucket_bytes):
    x = np.random.default_rng(total).standard_normal(total).astype(np.float32)
    jl, tl = jb.build_layout(total, bucket_bytes), tb.build_layout(total, bucket_bytes)
    jparts = jb.split_buckets(jnp.asarray(x), jl)
    tparts = tb.split_buckets(torch.from_numpy(x), tl)
    assert len(tparts) == len(jparts) == tl.n_buckets
    for a, b in zip(jparts, tparts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(tb.concat_buckets(tparts, tl).numpy(), x)
    with pytest.raises(ValueError, match="layout sizes"):
        tb.concat_buckets(tparts[:-1] + [tparts[-1][:-1]], tl)
