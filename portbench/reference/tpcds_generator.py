"""Frozen copy of the TPC-DS table generator the port's ``tpcds`` connector uses.

The benchmark's plain reference regenerates every table it reads from this
file, so it takes no table, column or dictionary from the program under
test. The arithmetic (splitmix64 counter streams over row indices, the scale
rules, the vocabularies, the per-table and per-column draws) is copied as it
stands, with the counter streams of the frozen TPC-H copy (``generator.py``);
only the containers are local: a column is a ``ColumnData`` of numpy values
and, for varchar, a sorted ``Dictionary`` of strings, with no value range,
device, cache or statistics attached. Change nothing here but by copying the
connector's generator again: the two have to make the same rows.

The generator's own notes: it reproduces the schema, the key relationships
and the value distributions the benchmark queries select on, not dsdgen's
rows; text columns draw from bounded pools; customer_demographics scales with
the scale factor instead of being fixed at 1,920,800 rows; fact row counts
approximate the spec's SF1 cardinalities through orders of 1..L lines.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Tuple

import numpy as np

from portbench.reference.generator import T, ColumnData, Dictionary, _randint, _stream

_EPOCH = datetime.date(1970, 1, 1)
# d_date_sk is the astronomical Julian day number (the dsdgen convention)
_JULIAN_EPOCH = 2440588  # julian day of 1970-01-01

DATE_LO = (datetime.date(1900, 1, 1) - _EPOCH).days
DATE_HI = (datetime.date(2100, 1, 1) - _EPOCH).days
SALES_DATE_LO = (datetime.date(1998, 1, 2) - _EPOCH).days
SALES_DATE_HI = (datetime.date(2002, 12, 30) - _EPOCH).days

_DEC2 = T.decimal(7, 2)

GENDERS = ["F", "M"]
MARITAL = ["D", "M", "S", "U", "W"]
EDUCATION = [
    "2 yr Degree", "4 yr Degree", "Advanced Degree", "College",
    "Primary", "Secondary", "Unknown",
]
STATES = [
    "AL", "CA", "FL", "GA", "IA", "IL", "IN", "KS", "KY", "LA", "MI",
    "MN", "MO", "NC", "NE", "NY", "OH", "OK", "PA", "SC", "TN", "TX",
    "VA", "WA", "WI",
]
CITIES = [
    "Antioch", "Bethel", "Centerville", "Clifton", "Concord", "Edgewood",
    "Fairview", "Five Points", "Georgetown", "Glendale", "Greenfield",
    "Greenwood", "Hamilton", "Highland", "Jackson", "Lakeside", "Lakeview",
    "Lebanon", "Liberty", "Marion", "Midway", "Mount Olive", "Mount Zion",
    "Newport", "Oak Grove", "Oak Hill", "Oakdale", "Oakland", "Pine Grove",
    "Pleasant Grove", "Pleasant Hill", "Providence", "Riverdale",
    "Riverside", "Salem", "Shady Grove", "Shiloh", "Springdale",
    "Spring Hill", "Sulphur Springs", "Summit", "Sunnyside", "Union",
    "Union Hill", "Walnut Grove", "Waterloo", "Wildwood", "Wilson",
    "Woodland", "Woodville",
]
STREET_NAMES = [
    "1st", "2nd", "3rd", "4th", "5th", "6th", "7th", "8th", "9th", "10th",
    "Adams", "Birch", "Broadway", "Cedar", "Center", "Cherry", "Chestnut",
    "Church", "College", "Davis", "Dogwood", "East", "Elm", "Forest",
    "Fourth", "Franklin", "Green", "Highland", "Hickory", "Hill", "Hillcrest",
    "Jackson", "Jefferson", "Johnson", "Lake", "Laurel", "Lee", "Lincoln",
    "Locust", "Madison", "Main", "Maple", "Meadow", "Mill", "North", "Oak",
    "Park", "Pine", "Poplar", "Railroad", "Ridge", "River", "Second",
    "Smith", "South", "Spring", "Spruce", "Sunset", "Sycamore", "Valley",
    "View", "Walnut", "Washington", "West", "Williams", "Willow", "Wilson",
    "Woodland",
]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
    "peach", "peru", "pink", "plum", "powder", "puff", "purple", "red",
    "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry", "Men", "Music",
    "Shoes", "Sports", "Women",
]
COMPANIES = ["able", "ation", "bar", "cally", "eing", "ese", "ought", "pri"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"]
PROMO_NAMES = ["able", "anti", "bar", "cally", "ese", "n st", "ought", "pri"]

SCHEMAS: Dict[str, List[Tuple[str, str]]] = {
    "date_dim": [
        ("d_date_sk", "bigint"), ("d_date", "date"), ("d_year", "integer"),
        ("d_moy", "integer"), ("d_dom", "integer"), ("d_qoy", "integer"),
        ("d_dow", "integer"),
    ],
    "income_band": [
        ("ib_income_band_sk", "bigint"), ("ib_lower_bound", "integer"),
        ("ib_upper_bound", "integer"),
    ],
    "household_demographics": [
        ("hd_demo_sk", "bigint"), ("hd_income_band_sk", "bigint"),
        ("hd_buy_potential", "varchar(15)"), ("hd_dep_count", "integer"),
        ("hd_vehicle_count", "integer"),
    ],
    "customer_demographics": [
        ("cd_demo_sk", "bigint"), ("cd_gender", "varchar(1)"),
        ("cd_marital_status", "varchar(1)"),
        ("cd_education_status", "varchar(20)"),
        ("cd_dep_count", "integer"),
    ],
    "customer_address": [
        ("ca_address_sk", "bigint"), ("ca_street_number", "varchar(10)"),
        ("ca_street_name", "varchar(60)"), ("ca_city", "varchar(60)"),
        ("ca_zip", "varchar(10)"), ("ca_state", "varchar(2)"),
    ],
    "customer": [
        ("c_customer_sk", "bigint"), ("c_customer_id", "varchar(16)"),
        ("c_current_cdemo_sk", "bigint"), ("c_current_hdemo_sk", "bigint"),
        ("c_current_addr_sk", "bigint"), ("c_first_sales_date_sk", "bigint"),
        ("c_first_shipto_date_sk", "bigint"), ("c_first_name", "varchar(20)"),
        ("c_last_name", "varchar(30)"),
    ],
    "item": [
        ("i_item_sk", "bigint"), ("i_item_id", "varchar(16)"),
        ("i_product_name", "varchar(50)"), ("i_color", "varchar(20)"),
        ("i_current_price", "decimal(7,2)"), ("i_category", "varchar(50)"),
        ("i_brand_id", "integer"),
    ],
    "store": [
        ("s_store_sk", "bigint"), ("s_store_id", "varchar(16)"),
        ("s_store_name", "varchar(50)"), ("s_zip", "varchar(10)"),
        ("s_state", "varchar(2)"),
    ],
    "warehouse": [
        ("w_warehouse_sk", "bigint"), ("w_warehouse_name", "varchar(20)"),
        ("w_state", "varchar(2)"),
    ],
    "web_site": [
        ("web_site_sk", "bigint"), ("web_site_id", "varchar(16)"),
        ("web_company_name", "varchar(50)"),
    ],
    "promotion": [
        ("p_promo_sk", "bigint"), ("p_promo_id", "varchar(16)"),
        ("p_promo_name", "varchar(50)"), ("p_channel_email", "varchar(1)"),
    ],
    "store_sales": [
        ("ss_sold_date_sk", "bigint"), ("ss_item_sk", "bigint"),
        ("ss_customer_sk", "bigint"), ("ss_cdemo_sk", "bigint"),
        ("ss_hdemo_sk", "bigint"), ("ss_addr_sk", "bigint"),
        ("ss_store_sk", "bigint"), ("ss_promo_sk", "bigint"),
        ("ss_ticket_number", "bigint"), ("ss_quantity", "integer"),
        ("ss_wholesale_cost", "decimal(7,2)"), ("ss_list_price", "decimal(7,2)"),
        ("ss_coupon_amt", "decimal(7,2)"), ("ss_net_profit", "decimal(7,2)"),
    ],
    "store_returns": [
        ("sr_returned_date_sk", "bigint"), ("sr_item_sk", "bigint"),
        ("sr_ticket_number", "bigint"), ("sr_return_amt", "decimal(7,2)"),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", "bigint"), ("cs_item_sk", "bigint"),
        ("cs_order_number", "bigint"), ("cs_quantity", "integer"),
        ("cs_ext_list_price", "decimal(7,2)"),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", "bigint"), ("cr_item_sk", "bigint"),
        ("cr_order_number", "bigint"), ("cr_refunded_cash", "decimal(7,2)"),
        ("cr_reversed_charge", "decimal(7,2)"), ("cr_store_credit", "decimal(7,2)"),
    ],
    "web_sales": [
        ("ws_sold_date_sk", "bigint"), ("ws_ship_date_sk", "bigint"),
        ("ws_item_sk", "bigint"), ("ws_order_number", "bigint"),
        ("ws_warehouse_sk", "bigint"), ("ws_ship_addr_sk", "bigint"),
        ("ws_web_site_sk", "bigint"), ("ws_ext_ship_cost", "decimal(7,2)"),
        ("ws_net_profit", "decimal(7,2)"),
    ],
    "web_returns": [
        ("wr_returned_date_sk", "bigint"), ("wr_item_sk", "bigint"),
        ("wr_order_number", "bigint"), ("wr_return_amt", "decimal(7,2)"),
    ],
}

# sf1 cardinalities (facts via orders x lines; spec counts in comments)
_SF1 = {
    "customer": 100_000,
    "customer_address": 50_000,
    "customer_demographics": 192_080,  # deviation: spec fixes 1,920,800
    "item": 18_000,
    "store": 12,
    "warehouse": 5,
    "web_site": 30,
    "promotion": 300,
    "store_sales_tickets": 240_000,   # x ~12 lines = 2.88M (spec 2,880,404)
    "catalog_sales_orders": 160_000,  # x ~9 lines = 1.44M (spec 1,441,548)
    "web_sales_orders": 60_000,       # x ~12 lines = 720K (spec 719,384)
}

_FIXED = {"date_dim": DATE_HI - DATE_LO, "income_band": 20,
          "household_demographics": 7_200}


def _dim_rows(name: str, sf: float) -> int:
    if name in _FIXED:
        return _FIXED[name]
    return max(10, round(_SF1[name] * sf))


def table_row_count(table: str, sf: float) -> int:
    """Row-count estimate (facts report the expected line count)."""
    if table in _FIXED:
        return _FIXED[table]
    if table in ("store_sales", "store_returns"):
        n = _dim_rows("store_sales_tickets", sf) * 12
        return n if table == "store_sales" else n // 10
    if table in ("catalog_sales", "catalog_returns"):
        n = _dim_rows("catalog_sales_orders", sf) * 9
        return n if table == "catalog_sales" else n // 10
    if table in ("web_sales", "web_returns"):
        n = _dim_rows("web_sales_orders", sf) * 12
        return n if table == "web_sales" else n // 4
    return _dim_rows(table, sf)


def order_range_count(table: str, sf: float) -> int:
    """Split-unit count: the generator row index for fact tables is the
    ORDER/TICKET index (lines expand per order), dimension tables the row."""
    if table in ("store_sales", "store_returns"):
        return _dim_rows("store_sales_tickets", sf)
    if table in ("catalog_sales", "catalog_returns"):
        return _dim_rows("catalog_sales_orders", sf)
    if table in ("web_sales", "web_returns"):
        return _dim_rows("web_sales_orders", sf)
    return table_row_count(table, sf)


def _vocab_col(vocab: List[str], codes: np.ndarray) -> ColumnData:
    order = np.argsort(np.asarray(vocab))
    sorted_vocab = [vocab[i] for i in order]
    inverse = np.empty(len(vocab), dtype=np.int32)
    inverse[order] = np.arange(len(vocab), dtype=np.int32)
    return ColumnData(
        T.varchar(), values=inverse[codes.astype(np.int64)],
        dictionary=Dictionary(sorted_vocab),
    )


def _pool(tag: int, idx: np.ndarray, vocab: List[str]) -> ColumnData:
    codes = np.asarray(_stream(tag, idx) % np.uint64(len(vocab)), dtype=np.int32)
    return _vocab_col(vocab, codes)


def _keyed_id(prefix: str, keys: np.ndarray, lo: int, hi: int) -> ColumnData:
    vocab = [f"{prefix}{k:011d}" for k in range(lo, hi)]
    return ColumnData(
        T.varchar(), values=(keys - lo).astype(np.int32),
        dictionary=Dictionary(vocab),
    )


def _dec(values_scaled: np.ndarray) -> ColumnData:
    return ColumnData(_DEC2, values=values_scaled.astype(np.int64))


def _key_col(keys: np.ndarray, hi: int) -> ColumnData:
    return ColumnData(T.BIGINT, keys.astype(np.int64))


def _julian(epoch_days: np.ndarray) -> np.ndarray:
    return epoch_days + _JULIAN_EPOCH


def generate(table: str, sf: float, lo: int, hi: int, columns=None) -> Dict[str, ColumnData]:
    """Generate rows of ``table`` for order/row range [lo, hi)."""
    need = set(columns) if columns is not None else {n for n, _ in SCHEMAS[table]}
    return _generate(table, sf, lo, hi, need)


def _generate(table: str, sf: float, lo: int, hi: int, need) -> Dict[str, ColumnData]:
    fn = {
        "date_dim": _gen_date_dim, "income_band": _gen_income_band,
        "household_demographics": _gen_hd, "customer_demographics": _gen_cd,
        "customer_address": _gen_ca, "customer": _gen_customer,
        "item": _gen_item, "store": _gen_store, "warehouse": _gen_warehouse,
        "web_site": _gen_web_site, "promotion": _gen_promotion,
        "store_sales": _gen_store_sales, "store_returns": _gen_store_returns,
        "catalog_sales": _gen_catalog_sales, "catalog_returns": _gen_catalog_returns,
        "web_sales": _gen_web_sales, "web_returns": _gen_web_returns,
    }[table]
    out = fn(sf, lo, hi, need)
    return {c: out[c] for c in out if c in need}


def _gen_date_dim(sf, lo, hi, need):
    days = np.arange(DATE_LO + lo, DATE_LO + hi, dtype=np.int64)
    # vectorized calendar decomposition via numpy datetime64
    d64 = days.astype("datetime64[D]")
    y = d64.astype("datetime64[Y]").astype(int) + 1970
    m = d64.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (d64 - d64.astype("datetime64[M]")).astype(int) + 1
    return {
        "d_date_sk": ColumnData(T.BIGINT, _julian(days)),
        "d_date": ColumnData(T.DATE, days.astype(np.int32)),
        "d_year": ColumnData(T.INTEGER, y.astype(np.int32)),
        "d_moy": ColumnData(T.INTEGER, m.astype(np.int32)),
        "d_dom": ColumnData(T.INTEGER, dom.astype(np.int32)),
        "d_qoy": ColumnData(T.INTEGER, ((m - 1) // 3 + 1).astype(np.int32)),
        "d_dow": ColumnData(T.INTEGER, ((days + 4) % 7).astype(np.int32)),
    }


def _gen_income_band(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    return {
        "ib_income_band_sk": _key_col(k, 20),
        "ib_lower_bound": ColumnData(T.INTEGER, ((k - 1) * 10000).astype(np.int32)),
        "ib_upper_bound": ColumnData(T.INTEGER, (k * 10000).astype(np.int32)),
    }


def _gen_hd(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    return {
        "hd_demo_sk": _key_col(k, _FIXED["household_demographics"]),
        "hd_income_band_sk": ColumnData(
            T.BIGINT, ((k - 1) % 20 + 1).astype(np.int64)),
        "hd_buy_potential": _pool(3001, idx, BUY_POTENTIAL),
        "hd_dep_count": ColumnData(T.INTEGER, _randint(3002, idx, 0, 9).astype(np.int32)),
        "hd_vehicle_count": ColumnData(T.INTEGER, _randint(3003, idx, 0, 4).astype(np.int32)),
    }


def _gen_cd(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    n = _dim_rows("customer_demographics", sf)
    return {
        "cd_demo_sk": _key_col(k, n),
        "cd_gender": _vocab_col(GENDERS, ((k - 1) % 2).astype(np.int32)),
        "cd_marital_status": _vocab_col(MARITAL, ((k - 1) // 2 % 5).astype(np.int32)),
        "cd_education_status": _vocab_col(
            EDUCATION, ((k - 1) // 10 % 7).astype(np.int32)),
        "cd_dep_count": ColumnData(
            T.INTEGER, ((k - 1) // 70 % 7).astype(np.int32)),
    }


def _gen_ca(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    nums = _randint(3101, idx, 1, 1000)
    num_vocab = [str(i) for i in range(1, 1001)]
    return {
        "ca_address_sk": _key_col(k, _dim_rows("customer_address", sf)),
        "ca_street_number": _vocab_col(num_vocab, (nums - 1).astype(np.int32)),
        "ca_street_name": _pool(3102, idx, STREET_NAMES),
        "ca_city": _pool(3103, idx, CITIES),
        "ca_zip": _vocab_col(
            [f"{z:05d}" for z in range(10000, 10100)],
            np.asarray(_stream(3104, idx) % np.uint64(100), dtype=np.int32)),
        "ca_state": _pool(3105, idx, STATES),
    }


def _gen_customer(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    n_cd = _dim_rows("customer_demographics", sf)
    n_hd = _FIXED["household_demographics"]
    n_ca = _dim_rows("customer_address", sf)
    first_sales = _randint(3201, idx, SALES_DATE_LO - 2920, SALES_DATE_LO)
    return {
        "c_customer_sk": _key_col(k, _dim_rows("customer", sf)),
        "c_customer_id": _keyed_id("AAAAAAAA", k, lo + 1, hi + 1),
        "c_current_cdemo_sk": ColumnData(
            T.BIGINT, _randint(3202, idx, 1, n_cd)),
        "c_current_hdemo_sk": ColumnData(
            T.BIGINT, _randint(3203, idx, 1, n_hd)),
        "c_current_addr_sk": ColumnData(
            T.BIGINT, _randint(3204, idx, 1, n_ca)),
        "c_first_sales_date_sk": ColumnData(
            T.BIGINT, _julian(first_sales)),
        "c_first_shipto_date_sk": ColumnData(
            T.BIGINT, _julian(first_sales + _randint(3205, idx, 1, 60))),
        "c_first_name": _pool(3206, idx, STREET_NAMES),
        "c_last_name": _pool(3207, idx, CITIES),
    }


def _gen_item(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    return {
        "i_item_sk": _key_col(k, _dim_rows("item", sf)),
        "i_item_id": _keyed_id("AAAAAAAA", k, lo + 1, hi + 1),
        "i_product_name": _keyed_id("product", k, lo + 1, hi + 1),
        "i_color": _pool(3301, idx, COLORS),
        "i_current_price": _dec(_randint(3302, idx, 100, 10000)),
        "i_category": _pool(3303, idx, CATEGORIES),
        "i_brand_id": ColumnData(
            T.INTEGER, _randint(3304, idx, 1001001, 10016017).astype(np.int32)),
    }


def _gen_store(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    return {
        "s_store_sk": _key_col(k, _dim_rows("store", sf)),
        "s_store_id": _keyed_id("AAAAAAAA", k, lo + 1, hi + 1),
        "s_store_name": _pool(3401, idx, PROMO_NAMES),
        "s_zip": _vocab_col(
            [f"{z:05d}" for z in range(10000, 10100)],
            np.asarray(_stream(3402, idx) % np.uint64(100), dtype=np.int32)),
        "s_state": _pool(3403, idx, STATES),
    }


def _gen_warehouse(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    return {
        "w_warehouse_sk": _key_col(k, _dim_rows("warehouse", sf)),
        "w_warehouse_name": _pool(3501, idx, CITIES),
        "w_state": _pool(3502, idx, STATES),
    }


def _gen_web_site(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    return {
        "web_site_sk": _key_col(k, _dim_rows("web_site", sf)),
        "web_site_id": _keyed_id("AAAAAAAA", k, lo + 1, hi + 1),
        "web_company_name": _vocab_col(
            COMPANIES, ((k - 1) % len(COMPANIES)).astype(np.int32)),
    }


def _gen_promotion(sf, lo, hi, need):
    k = np.arange(lo + 1, hi + 1, dtype=np.int64)
    idx = k.astype(np.uint64)
    return {
        "p_promo_sk": _key_col(k, _dim_rows("promotion", sf)),
        "p_promo_id": _keyed_id("AAAAAAAA", k, lo + 1, hi + 1),
        "p_promo_name": _pool(3601, idx, PROMO_NAMES),
        "p_channel_email": _vocab_col(["N", "Y"], ((k - 1) % 2).astype(np.int32)),
    }


# --- fact tables: order/ticket index -> 1..L lines -------------------------


def _cols(need, **makers) -> Dict[str, ColumnData]:
    """Evaluate only the requested columns (connector projection pushdown:
    the lambda per column defers its PRNG draws — the tpch generator's
    `if col in need:` pattern, in combinator form)."""
    return {k: f() for k, f in makers.items() if k in need}


def _lines(tag: int, order: np.ndarray, max_lines: int) -> np.ndarray:
    return 1 + np.asarray(
        _stream(tag, order.astype(np.uint64)) % np.uint64(max_lines),
        dtype=np.int64,
    )


def _expand_orders(tag: int, lo: int, hi: int, max_lines: int):
    """(order_key[n_lines], line_number[n_lines]) for order range [lo, hi)."""
    okey = np.arange(lo + 1, hi + 1, dtype=np.int64)
    nlines = _lines(tag, okey, max_lines)
    orders = np.repeat(okey, nlines)
    offsets = np.concatenate([[0], np.cumsum(nlines)[:-1]])
    lnum = (np.arange(len(orders)) - np.repeat(offsets, nlines) + 1).astype(np.int64)
    return orders, lnum


def _line_key(order: np.ndarray, lnum: np.ndarray, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (order.astype(np.uint64) * np.uint64(32)
                + lnum.astype(np.uint64) + np.uint64(salt))


def _gen_store_sales(sf, lo, hi, need):
    ticket, lnum = _expand_orders(4001, lo, hi, 23)
    lk = _line_key(ticket, lnum, 0)
    tidx = ticket.astype(np.uint64)
    n_item = _dim_rows("item", sf)
    return _cols(
        need,
        ss_sold_date_sk=lambda: ColumnData(
            T.BIGINT, _julian(_randint(4002, tidx, SALES_DATE_LO, SALES_DATE_HI))),
        ss_item_sk=lambda: ColumnData(
            T.BIGINT, _randint(4003, lk, 1, n_item)),
        ss_customer_sk=lambda: ColumnData(
            T.BIGINT, _randint(4004, tidx, 1, _dim_rows("customer", sf))),
        ss_cdemo_sk=lambda: ColumnData(
            T.BIGINT, _randint(4007, tidx, 1, _dim_rows("customer_demographics", sf))),
        ss_hdemo_sk=lambda: ColumnData(
            T.BIGINT, _randint(4008, tidx, 1, _FIXED["household_demographics"])),
        ss_addr_sk=lambda: ColumnData(
            T.BIGINT, _randint(4009, tidx, 1, _dim_rows("customer_address", sf))),
        ss_store_sk=lambda: ColumnData(
            T.BIGINT, _randint(4010, tidx, 1, _dim_rows("store", sf))),
        ss_promo_sk=lambda: ColumnData(
            T.BIGINT, _randint(4011, lk, 1, _dim_rows("promotion", sf))),
        ss_ticket_number=lambda: ColumnData(
            T.BIGINT, ticket),
        ss_quantity=lambda: ColumnData(
            T.INTEGER, _randint(4006, lk, 1, 100).astype(np.int32)),
        ss_wholesale_cost=lambda: _dec(_randint(4005, lk, 100, 10000)),
        ss_list_price=lambda: _dec(
            _randint(4005, lk, 100, 10000) + _randint(4012, lk, 10, 5000)),
        ss_coupon_amt=lambda: _dec(np.where(
            _stream(4013, lk) % np.uint64(5) == 0,
            _randint(4014, lk, 10, 2000), 0)),
        ss_net_profit=lambda: _dec(_randint(4015, lk, 0, 3000)),
    )


_RETURN_MOD = 10  # ~1 in 10 sales lines is returned


def _gen_store_returns(sf, lo, hi, need):
    ticket, lnum = _expand_orders(4001, lo, hi, 23)  # same draws as sales
    lk = _line_key(ticket, lnum, 0)
    returned = _stream(4101, lk) % np.uint64(_RETURN_MOD) == 0
    ticket, lnum, lk = ticket[returned], lnum[returned], lk[returned]
    n_item = _dim_rows("item", sf)
    return _cols(
        need,
        sr_returned_date_sk=lambda: ColumnData(
            T.BIGINT,
            _julian(_randint(4002, ticket.astype(np.uint64),
                             SALES_DATE_LO, SALES_DATE_HI)
                    + _randint(4102, lk, 1, 90))),
        sr_item_sk=lambda: ColumnData(
            T.BIGINT, _randint(4003, lk, 1, n_item)),
        sr_ticket_number=lambda: ColumnData(
            T.BIGINT, ticket),
        sr_return_amt=lambda: _dec(_randint(4103, lk, 100, 10000)),
    )


def _gen_catalog_sales(sf, lo, hi, need):
    order, lnum = _expand_orders(4201, lo, hi, 17)
    lk = _line_key(order, lnum, 1)
    n_item = _dim_rows("item", sf)
    return _cols(
        need,
        cs_sold_date_sk=lambda: ColumnData(
            T.BIGINT,
            _julian(_randint(4202, order.astype(np.uint64),
                             SALES_DATE_LO, SALES_DATE_HI))),
        cs_item_sk=lambda: ColumnData(
            T.BIGINT, _randint(4203, lk, 1, n_item)),
        cs_order_number=lambda: ColumnData(
            T.BIGINT, order),
        cs_quantity=lambda: ColumnData(
            T.INTEGER, _randint(4204, lk, 1, 100).astype(np.int32)),
        cs_ext_list_price=lambda: _dec(_randint(4205, lk, 100, 30000)),
    )


def _gen_catalog_returns(sf, lo, hi, need):
    order, lnum = _expand_orders(4201, lo, hi, 17)
    lk = _line_key(order, lnum, 1)
    returned = _stream(4301, lk) % np.uint64(_RETURN_MOD) == 0
    order, lnum, lk = order[returned], lnum[returned], lk[returned]
    n_item = _dim_rows("item", sf)
    return _cols(
        need,
        cr_returned_date_sk=lambda: ColumnData(
            T.BIGINT,
            _julian(_randint(4202, order.astype(np.uint64),
                             SALES_DATE_LO, SALES_DATE_HI)
                    + _randint(4302, lk, 1, 90))),
        cr_item_sk=lambda: ColumnData(
            T.BIGINT, _randint(4203, lk, 1, n_item)),
        cr_order_number=lambda: ColumnData(
            T.BIGINT, order),
        cr_refunded_cash=lambda: _dec(_randint(4303, lk, 0, 8000)),
        cr_reversed_charge=lambda: _dec(_randint(4304, lk, 0, 4000)),
        cr_store_credit=lambda: _dec(_randint(4305, lk, 0, 4000)),
    )


def _gen_web_sales(sf, lo, hi, need):
    order, lnum = _expand_orders(4401, lo, hi, 23)
    lk = _line_key(order, lnum, 2)
    oidx = order.astype(np.uint64)
    n_item = _dim_rows("item", sf)
    n_wh = _dim_rows("warehouse", sf)

    def _sold():
        return _randint(4402, oidx, SALES_DATE_LO, SALES_DATE_HI)

    return _cols(
        need,
        ws_sold_date_sk=lambda: ColumnData(
            T.BIGINT, _julian(_sold())),
        ws_ship_date_sk=lambda: ColumnData(
            T.BIGINT, _julian(_sold() + _randint(4403, lk, 1, 120))),
        ws_item_sk=lambda: ColumnData(
            T.BIGINT, _randint(4404, lk, 1, n_item)),
        ws_order_number=lambda: ColumnData(
            T.BIGINT, order),
        # per-LINE warehouse: orders spanning warehouses feed q95's ws_wh
        ws_warehouse_sk=lambda: ColumnData(
            T.BIGINT, _randint(4405, lk, 1, n_wh)),
        ws_ship_addr_sk=lambda: ColumnData(
            T.BIGINT, _randint(4406, oidx, 1, _dim_rows("customer_address", sf))),
        ws_web_site_sk=lambda: ColumnData(
            T.BIGINT, _randint(4407, oidx, 1, _dim_rows("web_site", sf))),
        ws_ext_ship_cost=lambda: _dec(_randint(4408, lk, 0, 10000)),
        ws_net_profit=lambda: _dec(_randint(4409, lk, 0, 20000)),
    )


def _gen_web_returns(sf, lo, hi, need):
    order, lnum = _expand_orders(4401, lo, hi, 23)
    lk = _line_key(order, lnum, 2)
    returned = _stream(4501, lk) % np.uint64(4) == 0  # ~25%
    order, lnum, lk = order[returned], lnum[returned], lk[returned]
    n_item = _dim_rows("item", sf)
    return _cols(
        need,
        wr_returned_date_sk=lambda: ColumnData(
            T.BIGINT,
            _julian(_randint(4402, order.astype(np.uint64),
                             SALES_DATE_LO, SALES_DATE_HI)
                    + _randint(4502, lk, 1, 120))),
        wr_item_sk=lambda: ColumnData(
            T.BIGINT, _randint(4404, lk, 1, n_item)),
        wr_order_number=lambda: ColumnData(
            T.BIGINT, order),
        wr_return_amt=lambda: _dec(_randint(4503, lk, 100, 10000)),
    )
