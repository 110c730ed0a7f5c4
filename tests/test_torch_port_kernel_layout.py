"""The pure-Python layouts that the K1 and K2 launches use, on the CPU.

``sinkhorn_layout`` cuts an (n, m) Sinkhorn problem into bands of rows, at
most one block per SM, and decides whether a band fits in shared memory;
``gw_layout`` cuts one GW label across a cluster of blocks. The CUDA sources
compute the same sizes; ``tests/test_torch_port_cuda.py`` holds the two to
each other on a card.
"""

import pytest

from otfusion_tpu_torch.ops.gw_kernel import (
    CLUSTER_SIZES,
    MAX_CAP,
    SMEM_LIMIT,
    gw_layout,
)
from otfusion_tpu_torch.ops.sinkhorn_kernel import sinkhorn_layout

SHAPES = [(1, 1), (37, 45), (100, 33), (257, 1000), (2048, 2048),
          (300, 20000), (5000, 7), (1, 60000)]


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("n,m", SHAPES)
def test_sinkhorn_layout_covers_every_row_and_column(n, m, sms):
    lay = sinkhorn_layout(n, m, sms)
    assert 1 <= lay.grid <= min(sms, n)
    # every block owns at least one row; together they own all n rows and
    # all m columns (a block past the last column merges none)
    assert (lay.grid - 1) * lay.rows < n <= lay.grid * lay.rows
    assert lay.cols == -(-m // lay.grid)
    assert lay.smem_bytes <= SMEM_LIMIT
    band = 4 * lay.rows * m
    if lay.route == "shared":
        assert lay.smem_bytes >= band + 4 * m
    else:
        assert lay.route == "device"
        assert band + 4 * m > SMEM_LIMIT - lay.smem_bytes


@pytest.mark.parametrize("n,m,sms,expected", [
    (2048, 2048, 132, (128, 16, 16, "shared")),   # the main path
    (300, 20000, 132, (100, 3, 200, "device")),   # 240 KB bands
    (257, 1000, 132, (129, 2, 8, "shared")),
    (1, 1, 132, (1, 1, 1, "shared")),
    (2048, 2048, 16, (16, 128, 128, "device")),
])
def test_sinkhorn_layout_main_path_and_routes(n, m, sms, expected):
    lay = sinkhorn_layout(n, m, sms)
    assert (lay.grid, lay.rows, lay.cols, lay.route) == expected


def test_sinkhorn_layout_refuses_empty_problems():
    for n, m, sms in ((0, 5, 132), (5, 0, 132), (5, 5, 0)):
        with pytest.raises(ValueError):
            sinkhorn_layout(n, m, sms)


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_gw_layout_every_cap(cluster):
    """Rows per block cover the cap; wherever the layout admits a cap it
    fits a block's shared memory, and caps above 64 need >= 2 blocks."""
    for cap in range(1, MAX_CAP + 1):
        try:
            lay = gw_layout(cap, cluster)
        except ValueError:
            assert cluster == 1 and cap > 64
            continue
        assert lay.cluster == cluster
        assert (cluster - 1) * lay.rows < cap + cluster - 1
        assert cap <= cluster * lay.rows < cap + cluster
        assert lay.rows <= 64
        assert lay.smem_bytes <= SMEM_LIMIT
        # the whole Cy and T Cy^T, and this block's rows of Cx and T
        assert lay.smem_bytes >= 4 * (2 * cap * cap + 2 * lay.rows * cap)


@pytest.mark.parametrize("cap,cluster,rows,smem", [
    (64, 4, 16, 51984),
    (128, 8, 16, 169232),
    (128, 2, 64, 218768),
    (1, 4, 1, 496),
])
def test_gw_layout_sizes(cap, cluster, rows, smem):
    lay = gw_layout(cap, cluster)
    assert (lay.rows, lay.smem_bytes) == (rows, smem)


def test_gw_layout_refuses_above_the_cap_limit():
    with pytest.raises(ValueError, match="limit"):
        gw_layout(MAX_CAP + 1, 8)
    with pytest.raises(ValueError, match="cluster size"):
        gw_layout(64, 3)
