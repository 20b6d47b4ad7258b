"""Each configuration's layout file: its digest is the recorded one, it
loads through ``FrozenQdTree.from_arrays``, and its record is its own."""

import json
import pathlib

import numpy as np
import pytest

from qdbench import datagen, layout

BENCH = pathlib.Path(layout.__file__).resolve().parent
CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_file_digest_and_load(name):
    from repro_torch.core.qdtree import FrozenQdTree

    config = layout.load_config(name)
    arrays = layout.load(config)
    record = config["layout_record"]
    assert layout.digest(arrays) == record["sha256"]
    tree = FrozenQdTree.from_arrays(arrays)
    assert (tree.n_leaves, tree.n_nodes, tree.depth) == (
        record["leaves"], record["nodes"], record["depth"])
    assert tree.cuts.n_cuts == record["cuts"]
    assert layout.schema(arrays) == datagen.schema_columns()
    depths = layout.leaf_depths(arrays)
    assert depths.max() == tree.depth and depths.min() >= 1


@pytest.mark.parametrize("name", CONFIGS)
def test_changed_layout_is_refused(name):
    config = layout.load_config(name)
    arrays = layout.load(config)
    arrays["ct_cutpoint"] = np.array(arrays["ct_cutpoint"]) + 1
    assert layout.digest(arrays) != config["layout_record"]["sha256"]


def test_configs_state_their_cut():
    for name in CONFIGS:
        config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert config["resident_rows"] % config["batch_rows"] == 0
        assert config["resident_rows"] < config["table_rows"]
        assert config["pass_rows"] == config["table_rows"]
        assert set(config["reduced"]) <= set(config)
        assert len(config["source"]) <= 200
