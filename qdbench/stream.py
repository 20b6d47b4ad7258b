"""The one generator of every traffic mix.

A mix is a data file, ``qdbench/traffic/<mix>.json``:

* ``entry``: the program's entry a pass drives, a module of
  ``qdbench/entries/`` (``ingest``: ``LayoutEngine.ingest``);
* ``order``: the order the resident rows arrive in: ``generated`` (rows
  independent of each other) or ``{"sort_by": <column>}`` (a stable sort
  by that column, made once at set-up);
* ``loop``: ``closed``, the next pass starts when the last one returned.

The configuration gives the sizes: ``resident_rows`` rows made on the
device from ``--seed`` by ``qdbench/datagen.py`` (a whole number of
batches), cut into batches of ``batch_rows``.  A pass sends ``pass_rows``
rows, the deployment's table: the resident batches in order, again from
the first where the table is larger than what is resident, the last batch
cut where the pass ends.  Every pass sends the same batches.
"""

from __future__ import annotations

import json
import pathlib

import torch

from qdbench import datagen

BENCH = pathlib.Path(__file__).resolve().parent
ORDERS = ("generated", "sort_by")


def load_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    order = mix["order"]
    if order != "generated" and (not isinstance(order, dict)
                                 or list(order) != ["sort_by"]):
        raise ValueError(f"mix {name}: order {order!r} is not one of "
                         f"{ORDERS}")
    if mix.get("loop") != "closed":
        raise ValueError(f"mix {name}: only a closed loop is driven")
    return mix


def resident(mix: dict, resident_rows: int, seed: int,
             device) -> torch.Tensor:
    """The resident rows, in the mix's order."""
    order = mix["order"]
    if order == "generated":
        return datagen.generate(resident_rows, seed, device)
    names = [name for name, _, _ in datagen.schema_columns()]
    return datagen.generate_sorted(resident_rows, seed, device,
                                   names.index(order["sort_by"]))


def pass_batches(rows: torch.Tensor, batch_rows: int,
                 pass_rows: int) -> list:
    """The batches of one pass (views of ``rows``): ``pass_rows`` rows,
    the resident rows cycled, in batches of ``batch_rows``."""
    n = int(rows.shape[0])
    if n % batch_rows:
        raise ValueError(f"{n} resident rows are not whole batches of "
                         f"{batch_rows}")
    whole = list(rows.split(batch_rows))
    full, last = divmod(int(pass_rows), batch_rows)
    out = [whole[i % len(whole)] for i in range(full)]
    if last:
        out.append(whole[full % len(whole)][:last])
    return out


def make(mix: dict, config: dict, seed: int,
         device) -> tuple[torch.Tensor, list]:
    """The resident rows and the batches of a pass."""
    rows = resident(mix, config["resident_rows"], seed, device)
    return rows, pass_batches(rows, config["batch_rows"],
                              config["pass_rows"])
