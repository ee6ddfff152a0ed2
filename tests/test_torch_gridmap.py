"""The PyTorch port's `core/gridmap.py` (its own copy of the JAX package's
host `GridMap`) against groan_rs_tpu's: every case runs the same calls
through both classes and compares what comes out — tile counts, values,
the text each writer produces, what `from_file` reads back, and every
error's class and code.  Tolerance: equal (host numpy in both)."""

import io

import numpy as np
import pytest

from groan_rs_tpu.core.gridmap import GridMap as JGridMap

from _torch_parity import raised
from groan_rs_tpu_torch import GridMap
from groan_rs_tpu_torch.core.gridmap import GridMap as TGridMap


def _state(gm):
    return (gm.n_tiles_x(), gm.n_tiles_y(), gm.n_tiles(), gm.span_x, gm.span_y,
            gm.tile_dim, gm.values.dtype.kind, gm.values.tolist())


def _text(gm, writer):
    buf = io.StringIO()
    getattr(gm, writer)(buf)
    return buf.getvalue()


def _basic(G, tmp):
    """test_hbonds_gridmap.py:76 — add_at rounds to tiles; accumulate drops
    points outside the map."""
    gm = G((0.0, 2.0), (0.0, 1.0), (1.0, 1.0))
    gm.add_at(0.1, 0.2)
    gm.add_at(1.9, 0.9)
    gm.add_at(9.0, 9.0)
    gm.accumulate(np.array([[1.0, 0.0], [1.2, 0.1], [5.0, 5.0]]))
    gm.accumulate(np.array([[0.4, 0.6], [1.6, 0.4]]), weights=[0.5, 2.5])
    return _state(gm), gm.get_at(1.0, 0.0), gm.get_at(7.0, 0.0)


def _struct_api(G, tmp):
    """test_hbonds_gridmap.py:231 — from_vec in both orders, queries,
    converted access, every writer, clear."""
    vals = np.arange(12, dtype=np.float64)
    gm = G.from_vec((0.0, 1.5), (0.0, 1.0), (0.5, 0.5), vals,
                    data_order="row", converter=lambda v: 2 * v)
    gmc = G.from_vec((0.0, 1.5), (0.0, 1.0), (0.5, 0.5), vals, data_order="column")
    out = [_state(gm), _state(gmc), gm.get_at(0.5, 0.5), gm.get_at_convert(0.5, 0.5),
           gm.get_at_convert(9.0, 9.0), gm.is_inside(1.5, 1.0), gm.is_inside(1.8, 0.0),
           gm.get_tile(0.6, 0.4), gm.get_tile(9.0, 0.0), gm.index2x(3), gm.index2y(2)]
    out += [_text(gm, w) for w in ("write_map", "write_map_column_major",
                                   "write_map_raw", "write_map_raw_column_major")]
    gm.set_at(1.0, 0.5, 7.5)
    out.append(gm.values.tolist())
    gm.clear()
    out.append(_state(gm))
    return out


def _from_box(G, tmp):
    class Box:
        x, y = 4.0, 3.0

    return _state(G.from_box(Box(), (0.5, 0.5)))


def _roundtrip(G, tmp):
    """test_hbonds_gridmap.py:94 and test_densmap_vanhove.py:125 — save in
    both orders and read back; the bytes each save writes."""
    gm = G((0.0, 2.0), (0.0, 1.0), (1.0, 1.0))
    gm.values[:] = np.arange(6).reshape(3, 2) * 0.25
    out = []
    for cm in (False, True):
        path = tmp / f"{G.__module__}.{cm}.dat"
        gm.save(path, column_major=cm)
        with open(path) as fh:
            out.append(fh.read())
        back = G.from_file(path, split=(), parser=float)
        out.append(_state(back))
    return out


_FILES = {
    "row": "0 0 1\n0 1 2\n1 0 3\n1 1 4\n2 0 5\n2 1 6\n",
    "column": "# map\n@ legend\n0|0|10\n1|0|11\n2|0|12\n0|1|13\n1|1|14\n2|1|15\n",
    "text_values": "0 0 a\n0 1 b\n1 0 c\n1 1 d\n",
    "empty_values": "0 0\n0 1\n1 0\n1 1 5\n",
    "not_increasing": "1 0 1\n1 1 2\n0 0 3\n0 1 4\n",
    "redefinition": "0 0 1\n0 1 2\n1 0 3\n1 0 4\n",
    "incomplete": "0 0 1\n0 1 2\n1 0 3\n",
    "spacing": "0 0 1\n0 1 2\n0 3 3\n1 0 4\n1 1 5\n1 3 6\n",
    "same": "1 1 1\n1 1 2\n",
    "bad_line": "0 0 1\nfoo\n",
    "bad_number": "0 x 1\n",
    "bad_value": "0 0 1\n0 1 zz\n",
    "comments_only": "# nothing\n",
}


def _reader(name, parser=float):
    def case(G, tmp):
        path = tmp / f"{name}.{G.__module__}.dat"
        path.write_text(_FILES[name])
        got = raised(lambda: G.from_file(path, parser=parser))
        if got is not None:
            return got
        return _state(G.from_file(path, parser=parser))

    return case


def _missing(G, tmp):
    return raised(lambda: G.from_file(tmp / "missing.dat"))


def _errors(G, tmp):
    """test_hbonds_gridmap.py:87 — spans, tiles, value counts, order and
    out-of-range writes raise the same codes."""
    gm = G((0.0, 2.0), (0.0, 1.0), (1.0, 1.0))
    return [raised(f) for f in (
        lambda: G((2.0, 0.0), (0.0, 1.0), (1.0, 1.0)),
        lambda: G((0.0, 2.0), (0.0, 1.0), (3.0, 1.0)),
        lambda: G((0.0, 2.0), (0.0, 1.0), (0.0, 1.0)),
        lambda: G.from_vec((0.0, 1.5), (0.0, 1.0), (0.5, 0.5), np.arange(5.0)),
        lambda: G.from_vec((0.0, 1.0), (0.0, 1.0), (1.0, 1.0), np.arange(4.0),
                           data_order="diagonal"),
        lambda: gm.set_at(5.0, 5.0, 1.0))]


CASES = {"basic": _basic, "struct_api": _struct_api, "from_box": _from_box,
         "roundtrip": _roundtrip, "missing": _missing, "errors": _errors,
         **{f"file_{k}": _reader(k) for k in _FILES},
         "file_text_parser": _reader("text_values", parser=lambda s: s),
         "file_none_parser": _reader("empty_values", parser=None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gridmap_parity(case, tmp_path):
    want = CASES[case](JGridMap, tmp_path)
    got = CASES[case](TGridMap, tmp_path)
    assert got == want


def test_gridmap_exported_at_top_level():
    assert GridMap is TGridMap
    assert GridMap.__module__ == "groan_rs_tpu_torch.core.gridmap"
