"""The pure-Python layouts that the K1 and K2 launches use, on the CPU.

``sinkhorn_layout`` cuts an (n, m) Sinkhorn problem into bands of rows, at
most one block per SM, and decides whether a band fits in shared memory;
``gw_layout`` cuts one GW label across a cluster of blocks (K1's cluster
route, cap <= 128) and ``gw_device_layout`` cuts L labels of any cap into
product tiles, rows and column strips over a cooperative grid (K1's device
route, cap > 128). The CUDA sources compute the same sizes;
``tests/test_torch_port_cuda.py`` holds the two to each other on a card.
"""

import pytest

from otfusion_tpu_torch.ops.gw_kernel import (
    CLUSTER_SIZES,
    DEV_BLOCKS_PER_SM,
    DEV_STRIP,
    DEV_TILE,
    DEV_WARPS,
    MAX_CAP,
    SMEM_LIMIT,
    gw_device_bytes,
    gw_device_layout,
    gw_layout,
    gw_route,
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


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("L,cap", [(1, 1), (2, 129), (4, 363), (1, 849),
                                   (1, 960), (10, 96), (37, 200),
                                   (1, 5000)])
def test_gw_device_layout_covers_every_row_and_column(L, cap, sms):
    """Product tiles cover every (row, column) of a label, column strips
    every column; the grid is co-resident (at most DEV_BLOCKS_PER_SM a
    SM), no larger than the largest phase's work, and at least one block;
    a block's shared memory is far under the limit."""
    lay = gw_device_layout(L, cap, sms)
    assert (lay.tiles - 1) * DEV_TILE < cap <= lay.tiles * DEV_TILE
    assert (lay.strips - 1) * DEV_STRIP < cap <= lay.strips * DEV_STRIP
    most = max(L * lay.tiles ** 2, -(-L * cap // DEV_WARPS), L * lay.strips)
    assert 1 <= lay.grid == min(sms * DEV_BLOCKS_PER_SM, most)
    assert lay.smem_bytes <= SMEM_LIMIT // 8


@pytest.mark.parametrize("L,cap,sms,expected", [
    (1, 849, 132, (14, 27, 196)),     # the harness screen as one label
    (2, 129, 132, (3, 5, 33)),        # the route's boundary
    (4, 363, 132, (6, 12, 182)),
    (1, 960, 132, (15, 30, 225)),
    (100, 200, 132, (4, 7, 264)),     # capped at 2 blocks a SM
])
def test_gw_device_layout_sizes(L, cap, sms, expected):
    lay = gw_device_layout(L, cap, sms)
    assert (lay.tiles, lay.strips, lay.grid) == expected
    assert lay.smem_bytes == 10752   # 2 x 16 x 68 + 2 x 8 x 32 floats


@pytest.mark.parametrize("cap,route", [(1, "cluster"), (128, "cluster"),
                                       (129, "device"), (960, "device")])
def test_gw_route_by_cap(cap, route):
    """The cluster route up to its limit of 128 rows, the device route
    from 129."""
    assert gw_route(cap) == route
    if route == "cluster":
        gw_layout(cap, 8 if cap > 64 else 4)
    else:
        with pytest.raises(ValueError, match="limit"):
            gw_layout(cap, 8)
        gw_device_layout(1, cap, 132)


def test_gw_device_bytes_and_refusals():
    # the plan, 4 work matrices, 8 vectors, the state and the results
    assert gw_device_bytes(1, 960) == 4 * (5 * 960 ** 2 + 8 * 960 + 2) \
        + 4 * 5 + 8
    with pytest.raises(ValueError):
        gw_device_layout(0, 10, 132)
    with pytest.raises(ValueError):
        gw_device_layout(1, 10, 0)
