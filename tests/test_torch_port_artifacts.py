"""The run's PNG artifacts (``utils.tsne``, ``utils.raster``,
``utils.plotting`` and the loops that write them) against the JAX package's
matplotlib and scikit-learn figures, on the CPU.

  * t-SNE: P against scikit-learn's ``_joint_probabilities_nn`` on the same
    neighbour distances (1e-6), the gradient and KL against
    ``_kl_divergence`` (1e-5 relative), the PCA start against scikit-learn's
    PCA after its scaling (1e-5 of its largest entry), and the final
    embedding against ``TSNE`` as the JAX function calls it
    (trustworthiness within 0.02; the KL, computed one way for both, no
    more than 10 % above scikit-learn's);
  * the colormap tables against matplotlib's (1/255);
  * the confusion matrix and t-SNE PNGs against the JAX functions' files:
    the same pixel sizes, the cells' colours and the digits' colour, the
    points' colours at their plotted positions.

The loops that write the files are in tests/test_torch_port_artifact_loops.py.

Every scikit-learn call runs under ``threadpool_limits(1)``: its OpenMP
threads make a 40-point t-SNE take seconds to a minute when the suite's
workers share the machine, against a quarter of a second with one.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_array
from scipy.spatial.distance import squareform
from threadpoolctl import threadpool_limits

from otfusion_tpu_torch.data.png_io import read_png
from otfusion_tpu_torch.utils import tsne as port_tsne
from otfusion_tpu_torch.utils.plotting import (
    draw_confusion_matrix,
    draw_tsne,
    save_confusion_matrix_png,
    save_tsne_png,
)
from otfusion_tpu_torch.utils.raster import COLORMAPS, colormap, normalize


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _two_clusters(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[: n // 2] += 2.5
    return x


def _neighbours(x):
    n = x.shape[0]
    perplexity = port_tsne.default_perplexity(n)
    k = port_tsne.n_neighbors(n, perplexity)
    dist, idx = port_tsne.knn_sqdist(torch.from_numpy(x), k)
    return perplexity, k, dist, idx


SIZES = [(40, 2), (60, 16)]


@pytest.mark.parametrize("n,d", SIZES)
def test_joint_probabilities_match_sklearn(n, d):
    from sklearn.manifold import _t_sne

    x = _two_clusters(n, d)
    perplexity, k, dist, idx = _neighbours(x)
    ours = port_tsne.joint_probabilities_nn(dist, idx, perplexity).numpy()
    graph = csr_array((dist.numpy().ravel(), idx.numpy().ravel(),
                       np.arange(0, n * k + 1, k)), shape=(n, n))
    with threadpool_limits(1):
        ref = _t_sne._joint_probabilities_nn(graph, perplexity, 0).toarray()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert ours.sum() == pytest.approx(1.0, abs=1e-12)


def test_knn_matches_sklearn_neighbours():
    """The neighbour sets and squared distances NearestNeighbors gives."""
    from sklearn.neighbors import NearestNeighbors

    x = _two_clusters(60, 16)
    _, k, dist, idx = _neighbours(x)
    with threadpool_limits(1):
        graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(
            mode="distance")
    graph.sort_indices()
    ref_idx = graph.indices.reshape(60, k)
    ref_d2 = graph.data.reshape(60, k) ** 2
    order = np.argsort(idx.numpy(), axis=1)
    np.testing.assert_array_equal(np.take_along_axis(idx.numpy(), order, 1),
                                  ref_idx)
    np.testing.assert_allclose(np.take_along_axis(dist.numpy(), order, 1),
                               ref_d2, rtol=1e-5)


@pytest.mark.parametrize("n,d", SIZES)
def test_kl_and_gradient_match_sklearn(n, d):
    from sklearn.manifold import _t_sne

    x = _two_clusters(n, d)
    perplexity, _, dist, idx = _neighbours(x)
    p = port_tsne.joint_probabilities_nn(dist, idx, perplexity)
    y = np.random.default_rng(1).normal(size=(n, 2))
    kl, grad = port_tsne.kl_divergence(torch.from_numpy(y), p)
    ref_kl, ref_grad = _t_sne._kl_divergence(
        y.ravel(), squareform(p.numpy(), checks=False), 1, n, 2)
    assert abs(float(kl) - ref_kl) <= 1e-5 * abs(ref_kl)
    err = np.abs(grad.numpy().ravel() - ref_grad).max()
    assert err <= 1e-5 * np.abs(ref_grad).max()


@pytest.mark.parametrize("n,d", [*SIZES, (20, 64)])
def test_pca_start_matches_sklearn(n, d):
    """Both of the port's routes: the covariance's eigenvectors (n > d) and
    the Gram matrix's (n <= d)."""
    from sklearn.decomposition import PCA

    x = _two_clusters(n, d).astype(np.float64)
    with threadpool_limits(1):
        ref = PCA(n_components=2).fit_transform(x).astype(np.float32)
    ref = ref / np.std(ref[:, 0]) * 1e-4
    ours = port_tsne.pca_init(torch.from_numpy(x)).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n,d", SIZES)
def test_embedding_quality_matches_sklearn_tsne(n, d):
    """Coordinates differ (scikit-learn approximates the repulsion with a
    Barnes-Hut tree, the port computes it exactly), quality does not:
    trustworthiness (5 neighbours) within 0.02 of scikit-learn's, and the
    KL of both embeddings against the same P, by the same function, no more
    than 10 % above scikit-learn's (the exact gradient reaches a lower KL:
    0.0828 against 0.0935 at n = 40)."""
    from sklearn.manifold import TSNE, trustworthiness

    x = _two_clusters(n, d)
    perplexity, _, dist, idx = _neighbours(x)
    ours = port_tsne.tsne(x, device="cpu")
    with threadpool_limits(1):
        ref = TSNE(n_components=2, random_state=42,
                   perplexity=perplexity).fit_transform(x)
        tw_ours = trustworthiness(x, ours.embedding, n_neighbors=5)
        tw_ref = trustworthiness(x, ref, n_neighbors=5)
    assert ours.embedding.shape == (n, 2)
    assert ours.embedding.dtype == np.float32
    assert abs(tw_ours - tw_ref) <= 0.02
    p = port_tsne.joint_probabilities_nn(dist, idx, perplexity)

    def kl(emb):
        return float(port_tsne.kl_divergence(
            torch.from_numpy(emb.astype(np.float64)), p)[0])

    assert kl(ours.embedding) <= 1.10 * kl(ref)
    # one host read a check, at most 20 in a run
    assert ours.checks <= 20


def test_an_init_array_replaces_the_pca_start():
    """``init=`` (scikit-learn's ``init=ndarray``): given the PCA start it
    runs as the default does; given another start, another run."""
    x = _two_clusters(40, 2)
    start = port_tsne.pca_init(torch.from_numpy(x))
    default = port_tsne.tsne(x, device="cpu")
    given = port_tsne.tsne(x, device="cpu", init=start.numpy())
    np.testing.assert_array_equal(given.embedding, default.embedding)
    assert given.n_iter == default.n_iter
    other = port_tsne.tsne(x, device="cpu", init=start.numpy()[::-1].copy())
    assert not np.array_equal(other.embedding, default.embedding)


@pytest.mark.parametrize("name", ["Blues", "coolwarm"])
def test_colormaps_match_matplotlib(name):
    import matplotlib

    cmap = matplotlib.colormaps[name]
    np.testing.assert_allclose(COLORMAPS[name],
                               cmap(np.linspace(0, 1, 256))[:, :3],
                               rtol=0, atol=1 / 255)
    v = np.random.default_rng(0).random(500)
    np.testing.assert_allclose(colormap(name, v), cmap(v)[:, :3], rtol=0,
                               atol=1 / 255)


def _jax_png_size(path):
    return read_png(path).shape[:2]


@pytest.mark.parametrize("case", ["two_classes_min_above_zero",
                                  "three_classes_with_zero"])
def test_confusion_matrix_png_against_jax(tmp_path, case):
    from matplotlib import colors as mcolors
    from otfusion_tpu.utils.plotting import save_confusion_matrix_png as jax_cm

    rng = np.random.default_rng(0)
    if case == "two_classes_min_above_zero":
        classes = {"AD_MRI_130_FIN": 0, "CN_MRI_229_FIN": 1}
        y, p = rng.integers(0, 2, 38), rng.integers(0, 2, 38)
    else:
        classes = {"AD": 0, "CN": 1, "MCI": 2}
        y = np.array([0] * 9 + [1] * 7 + [2] * 6)
        p = np.array([0] * 6 + [1] * 3 + [1] * 7 + [0] * 2 + [2] * 4)
    jax_cm(y, p, classes, tmp_path / "jax.png")
    save_confusion_matrix_png(y, p, classes, tmp_path / "port.png")
    ours = read_png(tmp_path / "port.png")
    assert ours.shape[:2] == _jax_png_size(tmp_path / "jax.png") == (800,
                                                                     1000)
    n = len(classes)
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (y, p), 1)
    canvas, boxes = draw_confusion_matrix(
        cm, [c.split("_")[0] for c in sorted(classes, key=classes.get)])
    np.testing.assert_array_equal(canvas.to_uint8(), ours)
    # imshow's colours: Normalize from the smallest count to the largest
    want = mcolors.Normalize()(cm.astype(float))
    from matplotlib import colormaps

    for i in range(n):
        for j in range(n):
            x0, y0, x1, y1 = boxes[i, j]
            cx = (x0 + x1) // 2
            cell = ours[y0 + (y1 - y0) // 4, cx].astype(int)
            ref = np.round(np.asarray(colormaps["Blues"](want[i, j])[:3])
                           * 255).astype(int)
            assert np.abs(cell - ref).max() <= 2, (i, j, cell, ref)
            # the digits around the centre: white above half the maximum
            cy = (y0 + y1) // 2
            digits = ours[cy - 8:cy + 9, cx - 12:cx + 13].astype(int)
            if cm[i, j] > cm.max() / 2:
                assert digits.min() >= cell.min() - 2
                if cell.max() < 200:
                    assert (digits.min(axis=2) >= 240).any()
            else:
                assert (digits.max(axis=2) <= 60).any()


def test_tsne_png_against_jax(tmp_path):
    from otfusion_tpu.utils.plotting import save_tsne_png as jax_tsne

    x = _two_clusters(40, 2)
    labels = [0] * 20 + [1] * 20
    with threadpool_limits(1):
        jax_tsne(x, labels, tmp_path / "jax.png")
    save_tsne_png(x, labels, tmp_path / "port.png", device="cpu")
    ours = read_png(tmp_path / "port.png")
    assert ours.shape[:2] == _jax_png_size(tmp_path / "jax.png") == (600,
                                                                     800)
    coords = port_tsne.tsne(x, device="cpu").embedding
    canvas, _ = draw_tsne(coords, labels,
                          "t-SNE of Validation Predictions (Best Model)")
    np.testing.assert_array_equal(canvas.to_uint8(), ours)


def test_tsne_points_have_their_colours_at_their_positions():
    """Points on a grid far apart: each centre pixel is coolwarm of the
    normalised label at alpha 0.7 over white (2 levels)."""
    from matplotlib import colormaps

    grid = np.stack(np.meshgrid(np.arange(5.0), np.arange(4.0)),
                    -1).reshape(-1, 2)
    labels = np.arange(len(grid)) % 3
    canvas, centres = draw_tsne(grid, labels, "t")
    image = canvas.to_uint8()
    for (px, py), label in zip(centres, labels):
        got = image[int(py), int(px)].astype(int)
        rgb = np.asarray(colormaps["coolwarm"](label / 2)[:3])
        want = np.round((0.7 * rgb + 0.3) * 255).astype(int)
        assert np.abs(got - want).max() <= 2, (label, got, want)
    assert normalize([3, 3], 3, 3).tolist() == [0.0, 0.0]
