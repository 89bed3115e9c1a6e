"""The port's synthetic set generator (popnet_tpu_torch.data.synthetic) against
the JAX package's test generator (tests/synthetic_data.py): the same files,
byte for byte, for the same arguments."""

import os

import pytest

from popnet_tpu_torch.cli import itop_table
from popnet_tpu_torch.data import synthetic

from tests import synthetic_data


def tree_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("n_locations,seed", [(2, 0), (5, 0), (2, 777), (5, 777)])
def test_build_writes_the_files_of_the_test_generator(tmp_path, n_locations, seed):
    """Every frame, mask, background and label file of `build` (4 scenes a
    location) equals tests/synthetic_data.build's, and so do the returned
    paths below each root."""
    a = synthetic_data.build(str(tmp_path / "jax"), n_images=4, n_locations=n_locations,
                             seed=seed)
    b = synthetic.build(str(tmp_path / "port"), n_images=4, n_locations=n_locations, seed=seed)
    ja, pa = tree_files(tmp_path / "jax"), tree_files(tmp_path / "port")
    assert sorted(ja) == sorted(pa)
    assert len(ja) == 2 + 2 + 4 * 2 * (1 + n_locations) + n_locations
    for name in ja:
        assert ja[name] == pa[name], name
    rel = {k: (os.path.relpath(v, tmp_path / "jax") if isinstance(v, str)
               else [os.path.relpath(p, tmp_path / "jax") for p in v]) for k, v in a.items()}
    assert rel == {k: (os.path.relpath(v, tmp_path / "port") if isinstance(v, str)
                       else [os.path.relpath(p, tmp_path / "port") for p in v])
                   for k, v in b.items()}


def test_build_itop_writes_the_files_of_the_test_generator(tmp_path):
    """`build_itop` equals tests/synthetic_data.build_itop's files, and the
    ITOP table builds its sets with it."""
    synthetic_data.build_itop(str(tmp_path / "jax"), n_images=5, seed=3)
    synthetic.build_itop(str(tmp_path / "port"), n_images=5, seed=3)
    ja, pa = tree_files(tmp_path / "jax"), tree_files(tmp_path / "port")
    assert sorted(ja) == sorted(pa) and len(ja) == 6
    for name in ja:
        assert ja[name] == pa[name], name
    assert itop_table.build_itop is synthetic.build_itop
