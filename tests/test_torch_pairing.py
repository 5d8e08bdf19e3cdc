"""The port's episodic pairing (``data/pairing.py``) and list dataset
(``data/simple.py``) against JAX's: with the same seed, the same index
tables and the same episodes."""

import numpy as np
import pytest

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    from protosam_tpu.data import pairing as jpairing
    from protosam_tpu.data import simple as jsimple
except ImportError:
    pass

from protosam_tpu_torch.data import pairing, simple


class _Slices:
    """A dataset of labelled slices with JAX's ``idx_by_class`` table."""

    def __init__(self, n: int = 12):
        rng = np.random.default_rng(0)
        self.items = [{"image": rng.normal(size=(3, 8, 8)).astype(np.float32),
                       "label": rng.integers(0, 4, (8, 8)).astype(np.float32)}
                      for _ in range(n)]
        self.idx_by_class = {"LIVER": [0, 2, 3, 7], "RK": [1, 4, 9, 10, 11],
                             "LK": [], "SPLEEN": [5, 6, 8]}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("n_ways,n_shots,n_queries", [(1, 1, 1), (2, 1, 2),
                                                      (1, 2, 1)])
def test_med_fewshot_matches_jax(n_ways, n_shots, n_queries):
    data = _Slices()
    kw = dict(n_ways=n_ways, n_shots=n_shots, n_queries=n_queries,
              max_iters_per_load=6, seed=3)
    ours, theirs = pairing.med_fewshot(data, **kw), \
        jpairing.med_fewshot(data, **kw)
    assert len(ours) == len(theirs) == 6
    assert ours.indices == theirs.indices
    for i in range(len(ours)):
        _same(ours[i], theirs[i])
    ours.update_index()
    theirs.update_index()
    assert ours.indices == theirs.indices


@pytest.mark.parametrize("n_elements", [[2, 1], 2, 3], ids=str)
def test_reload_paired_dataset_matches_jax(n_elements):
    data = _Slices()
    subsets = lambda mod: [mod.Subset(data, idx, class_id=c)
                           for c, idx in data.idx_by_class.items() if idx]
    ours = pairing.ReloadPairedDataset(subsets(pairing), n_elements, 5,
                                       seed=11)
    theirs = jpairing.ReloadPairedDataset(subsets(jpairing), n_elements, 5,
                                          seed=11)
    assert ours.indices == theirs.indices
    for i in range(5):
        _same(ours[i], theirs[i])
    with pytest.raises(ValueError, match="n_elements"):
        pairing.ReloadPairedDataset(subsets(pairing), 4, 5, seed=11)


def test_fgbg_masks_and_subset_match_jax():
    data = _Slices()
    lab = data[3]["label"]
    _same(pairing.get_fgbg_masks(lab, 2, [2, 3]),
          jpairing.get_fgbg_masks(lab, 2, [2, 3]))
    sub, jsub = pairing.Subset(data, [4, 1], class_id="RK"), \
        jpairing.Subset(data, [4, 1], class_id="RK")
    assert len(sub) == 2
    _same(sub[0], jsub[0])
    assert sub[1]["basic_class_id"] == "RK"


def test_simple_dataset_matches_jax():
    items = [{"image": np.full((2, 2), i, np.float32)} for i in range(3)]
    ours, theirs = simple.SimpleDataset(items, loops=4), \
        jsimple.SimpleDataset(items, loops=4)
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        _same(ours[i], theirs[i])
