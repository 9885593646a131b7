"""Text symbol table (port of ``vae_gslm_tpu/data/symbols.py``, which
the port may not import).

Sorted symbol set + ``<pad>/<sos>/<unk>`` specials; ``encode`` prepends
``<sos>``, ``decode`` strips it; JSON round-trip.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Set, Union


class Symbols:
    def __init__(self, symbols: Set[str], delimiter: str):
        self._symbols = set(symbols)
        ordered = sorted(self._symbols) + ["<unk>"]
        self.symbol = ["<pad>", "<sos>"] + ordered
        self.mapping = {s: i for i, s in enumerate(self.symbol)}
        self.delimiter = delimiter

    @property
    def pad_idx(self) -> int:
        return self.mapping["<pad>"]

    @property
    def sos_idx(self) -> int:
        return self.mapping["<sos>"]

    @property
    def unk_idx(self) -> int:
        return self.mapping["<unk>"]

    @property
    def num_symbols(self) -> int:
        return len(self.symbol)

    def encode(self, x: Union[str, List[str]]) -> List[int]:
        if isinstance(x, str):
            x = x.split(self.delimiter)
        ids = [self.mapping.get(s, self.unk_idx) for s in x]
        return [self.sos_idx] + ids

    def decode(self, x: Iterable[int]) -> str:
        return self.delimiter.join(
            self.symbol[e] for e in x if e != self.sos_idx)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"symbols": list(self._symbols),
                       "mapping": self.mapping,
                       "delimiter": self.delimiter}, f)

    @classmethod
    def load(cls, path: str) -> "Symbols":
        with open(path, "r") as f:
            d = json.load(f)
        return cls(set(d["symbols"]), d["delimiter"])
