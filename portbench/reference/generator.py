"""Frozen copy of the TPC-H table generator the port's ``tpch`` connector uses.

The benchmark's plain reference regenerates every table it reads from this
file, so it takes no table, column or dictionary from the program under
test. The arithmetic (splitmix64 counter streams over row indices, the scale
rules, the vocabularies, the per-table and per-column draws) is copied as it
stands; only the container types are local: a column is a ``ColumnData`` of
numpy values and, for varchar, a sorted ``Dictionary`` of strings, with no
device, cache or statistics attached. Change nothing here but by copying the
connector's generator again: the two have to make the same rows.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class T:
    """Type tags of the schema (names only)."""

    BIGINT = "bigint"
    INTEGER = "integer"
    DATE = "date"

    @staticmethod
    def varchar():
        return "varchar"

    @staticmethod
    def decimal(precision, scale):
        return f"decimal({precision},{scale})"


class Dictionary:
    """Sorted distinct strings; a varchar column holds int32 codes into it."""

    def __init__(self, sorted_values: Sequence[str]):
        self.values: List[str] = list(sorted_values)

    @classmethod
    def build(cls, strings) -> "Dictionary":
        return cls(sorted(set(strings)))

    def encode(self, strings) -> np.ndarray:
        index = {s: i for i, s in enumerate(self.values)}
        return np.fromiter((index[s] for s in strings), dtype=np.int32, count=len(strings))


@dataclasses.dataclass
class ColumnData:
    type: str
    values: np.ndarray
    dictionary: Optional[Dictionary] = None


# --- counter-based PRNG (splitmix64) ---------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray) -> np.ndarray:
    # operands are already uint64 (the _stream contract): the wrapping
    # arithmetic stays uint64 end to end, so no .astype copies — the old
    # per-round astype was 3 full-array copies per draw, a measurable
    # slice of cold staging at sf>=2
    with np.errstate(over="ignore"):
        x = x + _GOLDEN
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def _stream(tag: int, idx: np.ndarray) -> np.ndarray:
    """Independent uniform u64 stream ``tag`` evaluated at positions ``idx``."""
    with np.errstate(over="ignore"):
        base = np.uint64(tag) * np.uint64(0xD6E8FEB86659FD93)
        return _mix(base ^ idx.astype(np.uint64))


def _randint(tag: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform int64 in [lo, hi] inclusive."""
    span = np.uint64(hi - lo + 1)
    return lo + (_stream(tag, idx) % span).astype(np.int64)


# --- epoch-day helpers ------------------------------------------------------

_EPOCH = datetime.date(1970, 1, 1)


def _d(s: str) -> int:
    return (datetime.date.fromisoformat(s) - _EPOCH).days


START_DATE = _d("1992-01-01")
CURRENT_DATE = _d("1995-06-17")
END_DATE = _d("1998-08-02")

# --- vocabularies (spec lists; see TPC-H spec 4.2.2-4.2.3) ------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# (nation, region_index) in nationkey order 0..24 (spec table)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
MKT_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
PART_COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hotpink", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
    "yellow",
]
TYPE_SYLLABLE1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLLABLE2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLLABLE3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_SYLLABLE1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYLLABLE2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# Comment phrase pool: bounded vocabulary with the LIKE-relevant phrases
# ("special...requests", "Customer...Complaints", colors) mixed in at
# spec-plausible rates.
_COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "regular", "express", "special", "final", "pending", "bold", "even",
    "silent", "unusual", "daring", "requests", "deposits", "packages",
    "accounts", "instructions", "foxes", "pinto", "beans", "theodolites",
    "dependencies", "platelets", "ideas", "asymptotes", "somas", "sauternes",
    "warhorses", "sheaves", "sleep", "nag", "wake", "haggle", "cajole",
    "detect", "integrate", "engage", "about", "among", "across", "against",
]


def _phrase_pool(tag: int, size: int, words_per: int = 4) -> List[str]:
    idx = np.arange(size, dtype=np.uint64)
    cols = [
        np.asarray(_COMMENT_WORDS)[
            np.asarray(_stream(tag * 7 + k, idx) % np.uint64(len(_COMMENT_WORDS)), dtype=np.int64)
        ]
        for k in range(words_per)
    ]
    return [" ".join(t) for t in zip(*cols)]


_ORDER_COMMENT_POOL: List[str] = None
_GENERIC_COMMENT_POOL: List[str] = None


def _order_comment_pool() -> List[str]:
    global _ORDER_COMMENT_POOL
    if _ORDER_COMMENT_POOL is None:
        pool = _phrase_pool(11, 1024)
        # ~1.2% of orders match '%special%requests%' (Q13's exclusion pattern)
        for i in range(0, 1024, 83):
            pool[i] = "special packages wake quickly among the requests"
        _ORDER_COMMENT_POOL = pool
    return _ORDER_COMMENT_POOL


def _generic_comment_pool() -> List[str]:
    global _GENERIC_COMMENT_POOL
    if _GENERIC_COMMENT_POOL is None:
        _GENERIC_COMMENT_POOL = _phrase_pool(13, 1024)
    return _GENERIC_COMMENT_POOL


# --- scale rules ------------------------------------------------------------


def table_row_count(table: str, sf: float) -> int:
    if table == "region":
        return 5
    if table == "nation":
        return 25
    if table == "supplier":
        return max(1, round(10_000 * sf))
    if table == "customer":
        return max(1, round(150_000 * sf))
    if table == "part":
        return max(1, round(200_000 * sf))
    if table == "partsupp":
        return table_row_count("part", sf) * 4
    if table == "orders":
        return max(1, round(1_500_000 * sf))
    if table == "lineitem":
        # variable (1..7 lines per order); exact count needs the per-order
        # draw — report the expected value as a stats estimate
        return int(table_row_count("orders", sf) * 4)
    raise KeyError(table)


SCHEMAS: Dict[str, List[Tuple[str, str]]] = {
    "region": [
        ("r_regionkey", "bigint"), ("r_name", "varchar(25)"), ("r_comment", "varchar(152)"),
    ],
    "nation": [
        ("n_nationkey", "bigint"), ("n_name", "varchar(25)"),
        ("n_regionkey", "bigint"), ("n_comment", "varchar(152)"),
    ],
    "supplier": [
        ("s_suppkey", "bigint"), ("s_name", "varchar(25)"), ("s_address", "varchar(40)"),
        ("s_nationkey", "bigint"), ("s_phone", "varchar(15)"),
        ("s_acctbal", "decimal(12,2)"), ("s_comment", "varchar(101)"),
    ],
    "customer": [
        ("c_custkey", "bigint"), ("c_name", "varchar(25)"), ("c_address", "varchar(40)"),
        ("c_nationkey", "bigint"), ("c_phone", "varchar(15)"),
        ("c_acctbal", "decimal(12,2)"), ("c_mktsegment", "varchar(10)"),
        ("c_comment", "varchar(117)"),
    ],
    "part": [
        ("p_partkey", "bigint"), ("p_name", "varchar(55)"), ("p_mfgr", "varchar(25)"),
        ("p_brand", "varchar(10)"), ("p_type", "varchar(25)"), ("p_size", "integer"),
        ("p_container", "varchar(10)"), ("p_retailprice", "decimal(12,2)"),
        ("p_comment", "varchar(23)"),
    ],
    "partsupp": [
        ("ps_partkey", "bigint"), ("ps_suppkey", "bigint"), ("ps_availqty", "integer"),
        ("ps_supplycost", "decimal(12,2)"), ("ps_comment", "varchar(199)"),
    ],
    "orders": [
        ("o_orderkey", "bigint"), ("o_custkey", "bigint"), ("o_orderstatus", "varchar(1)"),
        ("o_totalprice", "decimal(12,2)"), ("o_orderdate", "date"),
        ("o_orderpriority", "varchar(15)"), ("o_clerk", "varchar(15)"),
        ("o_shippriority", "integer"), ("o_comment", "varchar(79)"),
    ],
    "lineitem": [
        ("l_orderkey", "bigint"), ("l_partkey", "bigint"), ("l_suppkey", "bigint"),
        ("l_linenumber", "integer"), ("l_quantity", "decimal(12,2)"),
        ("l_extendedprice", "decimal(12,2)"), ("l_discount", "decimal(12,2)"),
        ("l_tax", "decimal(12,2)"), ("l_returnflag", "varchar(1)"),
        ("l_linestatus", "varchar(1)"), ("l_shipdate", "date"),
        ("l_commitdate", "date"), ("l_receiptdate", "date"),
        ("l_shipinstruct", "varchar(25)"), ("l_shipmode", "varchar(10)"),
        ("l_comment", "varchar(44)"),
    ],
}

_DEC2 = T.decimal(12, 2)


def _vocab_col(vocab: List[str], codes_into_vocab: np.ndarray) -> ColumnData:
    """Column over an unsorted vocab: re-sort vocab, remap codes."""
    order = np.argsort(np.asarray(vocab))
    sorted_vocab = [vocab[i] for i in order]
    inverse = np.empty(len(vocab), dtype=np.int32)
    inverse[order] = np.arange(len(vocab), dtype=np.int32)
    return ColumnData(
        T.varchar(), values=inverse[codes_into_vocab], dictionary=Dictionary(sorted_vocab)
    )


def _keyed_name_col(prefix: str, keys: np.ndarray, lo: int, hi: int) -> ColumnData:
    """'Customer#000000042'-style columns: zero-padded -> lexicographic order
    equals key order, so the dictionary is the key range itself."""
    vocab = [f"{prefix}#{k:09d}" for k in range(lo, hi)]
    return ColumnData(
        T.varchar(), values=(keys - lo).astype(np.int32), dictionary=Dictionary(vocab)
    )


def _pool_comment_col(pool: List[str], tag: int, idx: np.ndarray) -> ColumnData:
    codes = np.asarray(_stream(tag, idx) % np.uint64(len(pool)), dtype=np.int64)
    return _vocab_col(pool, codes.astype(np.int32))


def _dec(values_scaled: np.ndarray) -> ColumnData:
    return ColumnData(_DEC2, values=values_scaled.astype(np.int64))


def _phone(nation: np.ndarray, tag: int, idx: np.ndarray) -> ColumnData:
    cc = 10 + nation
    a = _randint(tag + 1, idx, 100, 999)
    b = _randint(tag + 2, idx, 100, 999)
    c = _randint(tag + 3, idx, 1000, 9999)
    strs = [f"{w}-{x}-{y}-{z}" for w, x, y, z in zip(cc, a, b, c)]
    d = Dictionary.build(strs)
    return ColumnData(T.varchar(), values=d.encode(strs), dictionary=d)


def _memo1(fn):
    """One-draw memo: two columns built from the SAME random draw (e.g.
    nationkey + phone) share one materialization per build call."""
    cell = []

    def get():
        if not cell:
            cell.append(fn())
        return cell[0]

    return get


def _retail_price_scaled(partkey: np.ndarray) -> np.ndarray:
    # spec 4.2.3: retailprice = (90000 + (partkey/10 mod 20001) + 100*(partkey mod 1000)) / 100
    return (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)).astype(np.int64)


# --- per-table generators ---------------------------------------------------


def generate(table: str, sf: float, lo: int, hi: int, columns=None) -> Dict[str, ColumnData]:
    """Rows [lo, hi) of ``table`` (for orders and lineitem an ORDER index
    range; lineitem expands to that range's line rows), only ``columns``."""
    need = set(columns) if columns is not None else {n for n, _ in SCHEMAS[table]}
    return _generate(table, sf, lo, hi, need)


def _generate(table: str, sf: float, lo: int, hi: int, need) -> Dict[str, ColumnData]:
    if table == "orders":
        return _generate_orders(sf, lo, hi, need)
    if table == "lineitem":
        return _generate_lineitem(sf, lo, hi, need)
    if table == "region":
        idx = np.arange(lo, hi)
        pool = _generic_comment_pool()
        return {
            "r_regionkey": ColumnData(T.BIGINT, idx.astype(np.int64)),
            "r_name": _vocab_col(REGIONS[lo:hi], np.arange(hi - lo, dtype=np.int32)),
            "r_comment": _pool_comment_col(pool, 101, idx.astype(np.uint64)),
        }
    if table == "nation":
        idx = np.arange(lo, hi)
        names = [NATIONS[i][0] for i in range(lo, hi)]
        regionkeys = np.array([NATIONS[i][1] for i in range(lo, hi)], dtype=np.int64)
        return {
            "n_nationkey": ColumnData(T.BIGINT, idx.astype(np.int64)),
            "n_name": _vocab_col(names, np.arange(hi - lo, dtype=np.int32)),
            "n_regionkey": ColumnData(T.BIGINT, regionkeys),
            "n_comment": _pool_comment_col(_generic_comment_pool(), 102, idx.astype(np.uint64)),
        }
    if table == "supplier":
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        idx = keys.astype(np.uint64)

        def _s_comment():
            pool = list(_generic_comment_pool())
            # spec: 5 suppliers per SF*10k get Customer Complaints, 5 get
            # Recommends
            pool = pool + [
                "the furiously express Customer accounts detect Complaints",
                "blithely special packages wake Customer Recommends quickly",
            ]
            codes = np.asarray(_stream(205, idx) % np.uint64(1024), dtype=np.int64)
            complaints = _stream(206, idx) % np.uint64(2000) == 0
            recommends = _stream(207, idx) % np.uint64(2000) == 1
            codes = np.where(complaints, 1024, np.where(recommends, 1025, codes))
            return _vocab_col(pool, codes.astype(np.int32))

        # shared between s_nationkey and s_phone: one draw, not two
        _nation = _memo1(lambda: _randint(201, idx, 0, 24))

        builders = {
            "s_suppkey": lambda: ColumnData(T.BIGINT, keys),
            "s_name": lambda: _keyed_name_col("Supplier", keys, lo + 1, hi + 1),
            "s_address": lambda: _pool_comment_col(_generic_comment_pool(), 202, idx),
            "s_nationkey": lambda: ColumnData(T.BIGINT, _nation()),
            "s_phone": lambda: _phone(_nation(), 210, idx),
            "s_acctbal": lambda: _dec(_randint(203, idx, -99999, 999999)),
            "s_comment": _s_comment,
        }
        return {c: b() for c, b in builders.items() if c in need}
    if table == "customer":
        # generation honors ``need`` here exactly like orders/lineitem —
        # a q3-shaped scan (c_custkey, c_mktsegment) must not pay the
        # Python-heavy phone/name/address/comment synthesis it projects
        # away (pre-scan projection: the staging pipeline's "only needed
        # columns cross" rule applied at the source)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        idx = keys.astype(np.uint64)

        def _c_mktsegment():
            seg = np.asarray(_stream(302, idx) % np.uint64(5), dtype=np.int64)
            return _vocab_col(MKT_SEGMENTS, seg.astype(np.int32))

        # shared between c_nationkey and c_phone: one draw, not two
        _nation = _memo1(lambda: _randint(301, idx, 0, 24))

        builders = {
            "c_custkey": lambda: ColumnData(T.BIGINT, keys),
            "c_name": lambda: _keyed_name_col("Customer", keys, lo + 1, hi + 1),
            "c_address": lambda: _pool_comment_col(_generic_comment_pool(), 303, idx),
            "c_nationkey": lambda: ColumnData(T.BIGINT, _nation()),
            "c_phone": lambda: _phone(_nation(), 310, idx),
            "c_acctbal": lambda: _dec(_randint(304, idx, -99999, 999999)),
            "c_mktsegment": _c_mktsegment,
            "c_comment": lambda: _pool_comment_col(_generic_comment_pool(), 305, idx),
        }
        return {c: b() for c, b in builders.items() if c in need}
    if table == "part":
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        idx = keys.astype(np.uint64)

        def _p_name():
            w1 = np.asarray(_stream(401, idx) % np.uint64(92), dtype=np.int64)
            w2 = np.asarray(_stream(402, idx) % np.uint64(92), dtype=np.int64)
            # p_name: two color words (dbgen uses five; bounded-vocab
            # deviation)
            vocab = [f"{a} {b}" for a in PART_COLORS for b in PART_COLORS]
            return _vocab_col(vocab, (w1 * 92 + w2).astype(np.int32))

        # shared between p_mfgr and p_brand: one draw, not two
        _m = _memo1(lambda: _randint(403, idx, 1, 5))

        def _p_mfgr():
            vocab = [f"Manufacturer#{i}" for i in range(1, 6)]
            return _vocab_col(vocab, (_m() - 1).astype(np.int32))

        def _p_brand():
            n = _randint(404, idx, 1, 5)
            vocab = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
            return _vocab_col(vocab, ((_m() - 1) * 5 + (n - 1)).astype(np.int32))

        def _p_type():
            t1 = np.asarray(_stream(405, idx) % np.uint64(6), dtype=np.int64)
            t2 = np.asarray(_stream(406, idx) % np.uint64(5), dtype=np.int64)
            t3 = np.asarray(_stream(407, idx) % np.uint64(5), dtype=np.int64)
            vocab = [
                f"{a} {b} {c}" for a in TYPE_SYLLABLE1 for b in TYPE_SYLLABLE2 for c in TYPE_SYLLABLE3
            ]
            return _vocab_col(vocab, (t1 * 25 + t2 * 5 + t3).astype(np.int32))

        def _p_container():
            c1 = np.asarray(_stream(408, idx) % np.uint64(5), dtype=np.int64)
            c2 = np.asarray(_stream(409, idx) % np.uint64(8), dtype=np.int64)
            vocab = [f"{a} {b}" for a in CONTAINER_SYLLABLE1 for b in CONTAINER_SYLLABLE2]
            return _vocab_col(vocab, (c1 * 8 + c2).astype(np.int32))

        builders = {
            "p_partkey": lambda: ColumnData(T.BIGINT, keys),
            "p_name": _p_name,
            "p_mfgr": _p_mfgr,
            "p_brand": _p_brand,
            "p_type": _p_type,
            "p_size": lambda: ColumnData(
                T.INTEGER, _randint(410, idx, 1, 50).astype(np.int32)),
            "p_container": _p_container,
            "p_retailprice": lambda: _dec(_retail_price_scaled(keys)),
            "p_comment": lambda: _pool_comment_col(_generic_comment_pool(), 411, idx),
        }
        return {c: b() for c, b in builders.items() if c in need}
    if table == "partsupp":
        rows = np.arange(lo, hi, dtype=np.int64)
        part = rows // 4 + 1
        idx = rows.astype(np.uint64)

        def _ps_suppkey():
            scount = table_row_count("supplier", sf)
            i = rows % 4
            # spec 4.2.3: ps_suppkey spread so joins distribute evenly
            supp = (part + i * (scount // 4 + (part - 1) // scount)) % scount + 1
            return ColumnData(T.BIGINT, supp.astype(np.int64))

        builders = {
            "ps_partkey": lambda: ColumnData(T.BIGINT, part),
            "ps_suppkey": _ps_suppkey,
            "ps_availqty": lambda: ColumnData(
                T.INTEGER, _randint(501, idx, 1, 9999).astype(np.int32)),
            "ps_supplycost": lambda: _dec(_randint(502, idx, 100, 100000)),
            "ps_comment": lambda: _pool_comment_col(_generic_comment_pool(), 503, idx),
        }
        return {c: b() for c, b in builders.items() if c in need}
    raise KeyError(table)


# Order/line shared deterministic draws (both tables derive the same values
# from (orderkey, linenumber) — this is what keeps o_orderstatus consistent
# with lineitem linestatus without cross-table generation order).


def _order_keys(lo: int, hi: int) -> np.ndarray:
    return np.arange(lo + 1, hi + 1, dtype=np.int64)


def _line_count(okey: np.ndarray) -> np.ndarray:
    return 1 + np.asarray(_stream(601, okey.astype(np.uint64)) % np.uint64(7), dtype=np.int64)


def _order_date(okey: np.ndarray) -> np.ndarray:
    return _randint(602, okey.astype(np.uint64), START_DATE, END_DATE - 151)


def _line_key(okey: np.ndarray, lnum: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (okey.astype(np.uint64) * np.uint64(8) + lnum.astype(np.uint64)).astype(np.uint64)


def _line_ship_date(okey, lnum):
    return _order_date(okey) + _randint(603, _line_key(okey, lnum), 1, 121)


def _generate_orders(sf: float, lo: int, hi: int, need) -> Dict[str, ColumnData]:
    okey = _order_keys(lo, hi)
    idx = okey.astype(np.uint64)
    out: Dict[str, ColumnData] = {}
    if "o_orderkey" in need:
        out["o_orderkey"] = ColumnData(T.BIGINT, okey)
    if "o_custkey" in need:
        ccount = table_row_count("customer", sf)
        # spec: only 2/3 of customers have orders (custkey not divisible by 3)
        raw = _randint(604, idx, 1, max(ccount - 1, 1))
        cust = np.minimum(raw + (raw % 3 == 0), ccount)
        out["o_custkey"] = ColumnData(T.BIGINT, cust.astype(np.int64))
    if "o_orderdate" in need:
        out["o_orderdate"] = ColumnData(T.DATE, _order_date(okey).astype(np.int32))
    if "o_orderstatus" in need or "o_totalprice" in need:
        # order status/total derived from the order's line draws: O if all
        # lines ship after CURRENT_DATE, F if all before, else P
        nlines = _line_count(okey)
        all_f = np.ones(len(okey), dtype=bool)
        all_o = np.ones(len(okey), dtype=bool)
        total = np.zeros(len(okey), dtype=np.int64)
        pcount = table_row_count("part", sf)
        for ln in range(1, 8):
            mask = nlines >= ln
            lnum = np.full(len(okey), ln, dtype=np.int64)
            ship = _line_ship_date(okey, lnum)
            is_f = ship <= CURRENT_DATE
            all_f &= ~mask | is_f
            all_o &= ~mask | ~is_f
            if "o_totalprice" in need:
                lk = _line_key(okey, lnum)
                qty = _randint(605, lk, 1, 50)
                part = _randint(606, lk, 1, pcount)
                eprice = qty * _retail_price_scaled(part)
                disc = _randint(607, lk, 0, 10)
                tax = _randint(608, lk, 0, 8)
                line_total = (eprice * (100 - disc) * (100 + tax)) // 10000
                total += np.where(mask, line_total, 0)
        if "o_orderstatus" in need:
            status_codes = np.where(all_f, 0, np.where(all_o, 1, 2)).astype(np.int32)
            out["o_orderstatus"] = _vocab_col(["F", "O", "P"], status_codes)
        if "o_totalprice" in need:
            out["o_totalprice"] = _dec(total)
    if "o_orderpriority" in need:
        prio = np.asarray(_stream(610, idx) % np.uint64(5), dtype=np.int64)
        out["o_orderpriority"] = _vocab_col(ORDER_PRIORITIES, prio.astype(np.int32))
    if "o_clerk" in need:
        nclerks = max(1, int(1000 * max(sf, 0.001)))
        clerks = _randint(609, idx, 1, nclerks)
        clerk_vocab = [f"Clerk#{k:09d}" for k in range(1, nclerks + 1)]
        out["o_clerk"] = ColumnData(
            T.varchar(), (clerks - 1).astype(np.int32), dictionary=Dictionary(clerk_vocab)
        )
    if "o_shippriority" in need:
        out["o_shippriority"] = ColumnData(T.INTEGER, np.zeros(len(okey), dtype=np.int32))
    if "o_comment" in need:
        out["o_comment"] = _pool_comment_col(_order_comment_pool(), 611, idx)
    return out


def _generate_lineitem(sf: float, order_lo: int, order_hi: int, need) -> Dict[str, ColumnData]:
    okey_per_order = _order_keys(order_lo, order_hi)
    nlines = _line_count(okey_per_order)
    okey = np.repeat(okey_per_order, nlines)
    # linenumber: 1.. within each order (exclusive prefix sum — stays
    # shape-correct for an empty order range, e.g. a no-split device's scan)
    offsets = np.cumsum(nlines) - nlines
    lnum = (np.arange(len(okey)) - np.repeat(offsets, nlines) + 1).astype(np.int64)
    lk = _line_key(okey, lnum)
    out: Dict[str, ColumnData] = {}
    part = None
    if {"l_partkey", "l_suppkey", "l_extendedprice"} & need:
        part = _randint(606, lk, 1, table_row_count("part", sf))
    ship = None
    if {"l_shipdate", "l_receiptdate", "l_linestatus", "l_returnflag"} & need:
        ship = _order_date(okey) + _randint(603, lk, 1, 121)
    if "l_orderkey" in need:
        out["l_orderkey"] = ColumnData(T.BIGINT, okey)
    if "l_partkey" in need:
        out["l_partkey"] = ColumnData(T.BIGINT, part)
    if "l_suppkey" in need:
        # supplier must be one of the part's 4 partsupp suppliers (spec)
        scount = table_row_count("supplier", sf)
        j = _randint(612, lk, 0, 3)
        supp = (part + j * (scount // 4 + (part - 1) // scount)) % scount + 1
        out["l_suppkey"] = ColumnData(T.BIGINT, supp.astype(np.int64))
    if "l_linenumber" in need:
        out["l_linenumber"] = ColumnData(T.INTEGER, lnum.astype(np.int32))
    if {"l_quantity", "l_extendedprice"} & need:
        qty = _randint(605, lk, 1, 50)
        if "l_quantity" in need:
            out["l_quantity"] = _dec(qty * 100)
        if "l_extendedprice" in need:
            out["l_extendedprice"] = _dec(qty * _retail_price_scaled(part))
    if "l_discount" in need:
        out["l_discount"] = _dec(_randint(607, lk, 0, 10))
    if "l_tax" in need:
        out["l_tax"] = _dec(_randint(608, lk, 0, 8))
    if "l_shipdate" in need:
        out["l_shipdate"] = ColumnData(T.DATE, ship.astype(np.int32))
    if "l_commitdate" in need:
        commit = _order_date(okey) + _randint(613, lk, 30, 90)
        out["l_commitdate"] = ColumnData(T.DATE, commit.astype(np.int32))
    if {"l_receiptdate", "l_returnflag"} & need:
        receipt = ship + _randint(614, lk, 1, 30)
        if "l_receiptdate" in need:
            out["l_receiptdate"] = ColumnData(T.DATE, receipt.astype(np.int32))
        if "l_returnflag" in need:
            # returnflag: R or A if receipt <= current date else N
            returned = receipt <= CURRENT_DATE
            ra = np.asarray(_stream(615, lk) % np.uint64(2), dtype=np.int64)  # 0=A 1=R
            codes = np.where(returned, np.where(ra == 1, 2, 0), 1).astype(np.int32)
            out["l_returnflag"] = _vocab_col(["A", "N", "R"], codes)
    if "l_linestatus" in need:
        out["l_linestatus"] = _vocab_col(
            ["F", "O"], np.where(ship <= CURRENT_DATE, 0, 1).astype(np.int32)
        )
    if "l_shipinstruct" in need:
        instr = np.asarray(_stream(616, lk) % np.uint64(4), dtype=np.int64)
        out["l_shipinstruct"] = _vocab_col(SHIP_INSTRUCTIONS, instr.astype(np.int32))
    if "l_shipmode" in need:
        mode = np.asarray(_stream(617, lk) % np.uint64(7), dtype=np.int64)
        out["l_shipmode"] = _vocab_col(SHIP_MODES, mode.astype(np.int32))
    if "l_comment" in need:
        out["l_comment"] = _pool_comment_col(_generic_comment_pool(), 618, lk)
    return out
