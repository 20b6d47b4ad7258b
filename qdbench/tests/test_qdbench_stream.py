"""A pass's batches: the resident rows cycled until the pass has sent its
rows, the last batch cut; the mixes' orders."""

import pytest
import torch

from qdbench import stream


def test_a_pass_cycles_the_resident_batches_and_cuts_the_last():
    rows = torch.arange(40).reshape(10, 4)
    got = stream.pass_batches(rows, 2, 23)
    assert [b.shape[0] for b in got] == [2] * 11 + [1]
    assert torch.equal(torch.cat(got), torch.cat([rows, rows, rows[:3]]))
    assert got[5].data_ptr() == got[0].data_ptr()  # views, not copies
    assert [b.shape[0] for b in stream.pass_batches(rows, 2, 20)] == [2] * 10
    assert torch.equal(torch.cat(stream.pass_batches(rows, 2, 5)), rows[:5])


def test_resident_rows_are_whole_batches():
    with pytest.raises(ValueError):
        stream.pass_batches(torch.zeros(10, 4), 3, 30)


def test_the_stream_mix_arrives_in_ship_date_order():
    rows = stream.resident(stream.load_mix("stream"), 3000, 5, "cpu")
    assert bool((rows[1:, 0] >= rows[:-1, 0]).all())
    bulk = stream.resident(stream.load_mix("bulk"), 3000, 5, "cpu")
    assert torch.equal(rows.sum(0), bulk.sum(0))
