"""The six TPC-DS queries of the ``tpcds`` family in plain PyTorch: the
benchmark's reference answers.

Each query reads the tables of ``DsTables`` (regenerated from the frozen
copy of the connector's generator, ``tpcds_generator.py``) and the
substitution parameters of ``queries/tpcds/params.py``, and returns its rows
in the canonical form of ``compare.py``: ints, strings and
``("d", unscaled, scale)`` for decimals. Joins to a dimension are key lookups
(``searchsorted`` over its sorted keys); a join of two fact tables on a
composite key, whose rows are never read, is a count of matches a key, so
each row enters an aggregate with its multiplicity; q95's ``ws_wh`` (the
orders whose lines leave from more than one warehouse) is the orders whose
least and greatest warehouse differ, so no pair of lines is made. Groups are
``torch.unique`` inverses, sums ``index_add_``, exact decimals scaled int64
through ``arith.py`` (Trino's rules, the division of query 101 included).
Nothing here imports the program under test or takes anything it made.
"""
from __future__ import annotations

import bisect
import datetime
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import tpcds_generator as G
from portbench.reference.arith import Arith
from portbench.reference.compare import _ordered, _sortable, canonical, first_difference  # noqa: F401
from portbench.reference.tables import _merge_varchar
from portbench.reference.tpch import code, lexsort, lookup

_EPOCH = datetime.date(1970, 1, 1)
_MIN_CHUNK = 1 << 16

# ORDER BY keys of each query: (column, descending); None where the query
# returns one row. q64 orders by some of its columns only: rows tied on them
# are compared as a multiset
ORDER_BY: Dict[int, Optional[Sequence[Tuple[int, bool]]]] = {
    64: [(0, False), (1, False), (20, False), (13, False), (14, False), (15, False),
         (16, False), (17, False)],
    95: None, 101: [(0, False), (2, True), (1, False)], 102: [(0, False), (4, False),
                                                            (1, False), (2, False)],
    103: [(0, False)], 104: None,
}


def same_answer(q: int, got: List[tuple], want: List[tuple]) -> bool:
    """The program's canonical rows ``got`` against the reference's ``want``:
    equal, or the same multiset in an order the ORDER BY allows."""
    if got == want:
        return True
    order = ORDER_BY.get(q)
    if order is None or len(got) != len(want):
        return False
    if sorted(map(repr, got)) != sorted(map(repr, want)):
        return False
    return _ordered(got, order)


class DsTables:
    """Columns of TPC-DS at scale factor ``sf`` on ``device``, made on
    demand: each table generated in row ranges (the fact tables by order or
    ticket) on a few host threads, each column moved to the device once. A
    varchar column is an int32 tensor of codes into a sorted list of strings,
    so the order of its codes is the order of its strings."""

    def __init__(self, sf: float, device, threads: int = 8):
        self.sf = sf
        self.device = torch.device(device)
        self.threads = threads
        self._cols: Dict[Tuple[str, str], torch.Tensor] = {}
        self._vocab: Dict[Tuple[str, str], List[str]] = {}

    def load(self, table: str, columns: Iterable[str]) -> None:
        missing = [c for c in columns if (table, c) not in self._cols]
        if not missing:
            return
        n = G.order_range_count(table, self.sf)
        k = max(1, min(self.threads * 2, n // _MIN_CHUNK))
        bounds = np.linspace(0, n, k + 1).astype(np.int64)
        ranges = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

        def gen(r):
            return G.generate(table, self.sf, r[0], r[1], missing)

        if len(ranges) == 1:
            chunks = [gen(ranges[0])]
        else:
            with ThreadPoolExecutor(min(self.threads, len(ranges))) as pool:
                chunks = list(pool.map(gen, ranges))
        for c in missing:
            parts = [ch[c] for ch in chunks]
            if parts[0].dictionary is not None:
                values, vocab = _merge_varchar([(p.values, p.dictionary.values) for p in parts])
                self._vocab[(table, c)] = vocab
            else:
                values = np.concatenate([p.values for p in parts])
            if values.dtype != np.int32:
                values = values.astype(np.int64, copy=False)
            self._cols[(table, c)] = torch.from_numpy(values).to(self.device)
            del values
        del chunks

    def col(self, table: str, column: str) -> torch.Tensor:
        self.load(table, [column])
        return self._cols[(table, column)]

    def vocab(self, table: str, column: str) -> List[str]:
        self.load(table, [column])
        return self._vocab[(table, column)]


def _group(keys: Sequence[torch.Tensor]):
    """(distinct key rows, inverse) of rows keyed by several int columns."""
    stacked = torch.stack([k.to(torch.int64) for k in keys], dim=1)
    return torch.unique(stacked, dim=0, return_inverse=True)


def _matches(key: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """How many rows of ``other`` hold each row's ``key`` (an equi-join's
    multiplicity from the side of ``key``)."""
    if other.numel() == 0:
        return torch.zeros_like(key)
    okeys, counts = torch.unique(other, return_counts=True)
    pos, hit = lookup(okeys, key)
    return torch.where(hit, counts[pos], torch.zeros_like(counts[pos]))


class Q:
    """One evaluation of the six queries over ``tables`` with ``arith``."""

    def __init__(self, tables: DsTables, arith: Arith):
        self.t = tables
        self.a = arith
        self.dev = tables.device

    def c(self, table, col):
        return self.t.col(table, col)

    def dec(self, table, col, sel=None):
        v = self.t.col(table, col)
        return self.a.col(v if sel is None else v[sel], 2)

    def s(self, table, col, codes) -> List[str]:
        vocab = self.t.vocab(table, col)
        return [vocab[i] for i in codes.tolist()]

    def _dim(self, table, key, fk):
        """Rows of dimension ``table`` (key column ``key``) for ``fk``."""
        return lookup(self.c(table, key), fk)

    def _year(self, date_sk):
        row, hit = self._dim("date_dim", "d_date_sk", date_sk)
        return self.c("date_dim", "d_year")[row].to(torch.int64), hit

    # ------------------------------------------------------------ queries
    def q64(self, p):
        a = self.a
        n_item = int(self.c("item", "i_item_sk").max()) + 1
        # cs_ui: catalog sales joined with their returns on (item, order), by item
        cs_item = self.c("catalog_sales", "cs_item_sk")
        cs_key = self.c("catalog_sales", "cs_order_number") * n_item + cs_item
        cr_key = self.c("catalog_returns", "cr_order_number") * n_item \
            + self.c("catalog_returns", "cr_item_sk")
        refund = a.add(a.add(self.dec("catalog_returns", "cr_refunded_cash"),
                             self.dec("catalog_returns", "cr_reversed_charge")),
                       self.dec("catalog_returns", "cr_store_credit"))
        m_cs = _matches(cs_key, cr_key)  # returns matching each sales line
        m_cr = _matches(cr_key, cs_key)  # sales lines matching each return
        sale_rows = m_cs > 0
        ret_rows = m_cr > 0
        sale = a.mul(self.dec("catalog_sales", "cs_ext_list_price", sale_rows),
                     a.col(m_cs[sale_rows], 0))
        ref = a.mul((refund[0][ret_rows], refund[1]), a.col(m_cr[ret_rows], 0))
        sale_by = a.sum_by(sale, cs_item[sale_rows], n_item)
        ref_by = a.sum_by(ref, (cr_key[ret_rows] % n_item), n_item)
        has = torch.zeros(n_item, dtype=torch.bool, device=self.dev)
        has[cs_item[sale_rows]] = True
        cs_ui = has & a.cmp(sale_by, a.mul(a.lit("2"), ref_by), ">")

        # the items the query keeps: cs_ui, colour, price
        colours = [p[f"COLOR{i}"] for i in range(1, 7)]
        i_sk = self.c("item", "i_item_sk")
        cvocab = self.t.vocab("item", "i_color")
        cmask = torch.tensor([v in colours for v in cvocab], dtype=torch.bool, device=self.dev)
        price = self.dec("item", "i_current_price")
        lo = int(p["PRICE"])
        item_ok = torch.zeros(n_item, dtype=torch.bool, device=self.dev)
        item_ok[i_sk] = cmask[self.c("item", "i_color")] \
            & a.cmp(price, a.lit(str(lo)), ">=") & a.cmp(price, a.lit(str(lo + 10)), "<=") \
            & a.cmp(price, a.lit(str(lo + 1)), ">=") & a.cmp(price, a.lit(str(lo + 15)), "<=")
        item_ok &= cs_ui

        # cross_sales: store sales of those items with their returns, each
        # sales line weighted by its matching returns
        ss_item = self.c("store_sales", "ss_item_sk")
        sm = item_ok[ss_item]
        ss_item = ss_item[sm]
        ss_key = self.c("store_sales", "ss_ticket_number")[sm] * n_item + ss_item
        sr_key = self.c("store_returns", "sr_ticket_number") * n_item \
            + self.c("store_returns", "sr_item_sk")
        w = _matches(ss_key, sr_key)

        def ss(col):
            return self.c("store_sales", col)[sm]

        s_row, s_hit = self._dim("store", "s_store_sk", ss("ss_store_sk"))
        y1, d1_hit = self._year(ss("ss_sold_date_sk"))
        c_row, c_hit = self._dim("customer", "c_customer_sk", ss("ss_customer_sk"))
        cd1, cd1_hit = self._dim("customer_demographics", "cd_demo_sk", ss("ss_cdemo_sk"))
        hd1, hd1_hit = self._dim("household_demographics", "hd_demo_sk", ss("ss_hdemo_sk"))
        ad1, ad1_hit = self._dim("customer_address", "ca_address_sk", ss("ss_addr_sk"))
        _, pr_hit = self._dim("promotion", "p_promo_sk", ss("ss_promo_sk"))
        it_row, it_hit = self._dim("item", "i_item_sk", ss_item)

        def cust(col):
            return self.c("customer", col)[c_row]

        cd2, cd2_hit = self._dim("customer_demographics", "cd_demo_sk", cust("c_current_cdemo_sk"))
        hd2, hd2_hit = self._dim("household_demographics", "hd_demo_sk",
                                 cust("c_current_hdemo_sk"))
        ad2, ad2_hit = self._dim("customer_address", "ca_address_sk", cust("c_current_addr_sk"))
        y2, d2_hit = self._year(cust("c_first_sales_date_sk"))
        y3, d3_hit = self._year(cust("c_first_shipto_date_sk"))
        hd_band = self.c("household_demographics", "hd_income_band_sk")
        _, ib1_hit = self._dim("income_band", "ib_income_band_sk", hd_band[hd1])
        _, ib2_hit = self._dim("income_band", "ib_income_band_sk", hd_band[hd2])
        marital = self.c("customer_demographics", "cd_marital_status")
        keep = (w > 0) & s_hit & d1_hit & c_hit & cd1_hit & hd1_hit & ad1_hit & pr_hit \
            & it_hit & cd2_hit & hd2_hit & ad2_hit & d2_hit & d3_hit & ib1_hit & ib2_hit \
            & (marital[cd1] != marital[cd2])
        addr = ("ca_street_number", "ca_street_name", "ca_city", "ca_zip")
        keys = [ss_item, self.c("store", "s_store_name")[s_row], self.c("store", "s_zip")[s_row]] \
            + [self.c("customer_address", col)[ad1] for col in addr] \
            + [self.c("customer_address", col)[ad2] for col in addr] + [y1, y2, y3]
        keys = [k[keep] for k in keys]
        w = w[keep]
        if w.numel() == 0:
            return []
        gkey, inv = _group(keys)
        g = gkey.shape[0]
        cnt = torch.zeros(g, dtype=torch.int64, device=self.dev).index_add_(0, inv, w)
        wd = a.col(w, 0)
        sums = [a.host(a.sum_by(a.mul((self.dec("store_sales", col, sm)[0][keep], 2), wd),
                                inv, g))
                for col in ("ss_wholesale_cost", "ss_list_price", "ss_coupon_amt")]
        gk = gkey.tolist()
        cnt = cnt.tolist()
        # the self-join of cross_sales: year YEAR against YEAR + 1 on item, store name and zip
        year = int(p["YEAR"])
        later: Dict[tuple, List[int]] = {}
        for j, k in enumerate(gk):
            if k[11] == year + 1:
                later.setdefault((k[0], k[1], k[2]), []).append(j)
        pairs = [(i, j) for i, k in enumerate(gk) if k[11] == year
                 for j in later.get((k[0], k[1], k[2]), ()) if cnt[j] <= cnt[i]]
        if not pairs:
            return []
        names = self.t.vocab("item", "i_product_name")
        pname = self.c("item", "i_product_name")
        name_of = {int(sk): names[int(c)] for sk, c in zip(i_sk.tolist(), pname.tolist())}
        v = {col: self.t.vocab(tab, col) for tab, col in (
            ("store", "s_store_name"), ("store", "s_zip"))}
        av = [self.t.vocab("customer_address", col) for col in addr]
        rows = []
        for i, j in pairs:
            k = gk[i]
            rows.append((name_of[k[0]], v["s_store_name"][k[1]], v["s_zip"][k[2]])
                        + tuple(av[n][k[3 + n]] for n in range(4))
                        + tuple(av[n][k[7 + n]] for n in range(4))
                        + (k[11], cnt[i]) + tuple(a.out(s[i]) for s in sums)
                        + tuple(a.out(s[j]) for s in sums) + (gk[j][11], cnt[j]))
        return _sorted(rows, ORDER_BY[64])

    def q95(self, p):
        a = self.a
        order = self.c("web_sales", "ws_order_number")
        wh = self.c("web_sales", "ws_warehouse_sk")
        n = int(order.max()) + 1 if order.numel() else 1
        big = torch.iinfo(torch.int64).max
        lo = torch.full((n,), big, dtype=torch.int64, device=self.dev)
        hi = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        lo.scatter_reduce_(0, order, wh, reduce="amin")
        hi.scatter_reduce_(0, order, wh, reduce="amax")
        multi = (lo != hi) & (hi >= 0)  # ws_wh's orders
        wr = self.c("web_returns", "wr_order_number")
        returned = torch.zeros(n, dtype=torch.bool, device=self.dev)
        wr = wr[wr < n]
        returned[wr[multi[wr]]] = True  # web_returns joined with ws_wh
        start = datetime.date(int(p["YEAR"]), int(p["MONTH"]), 1)
        d0 = (start - _EPOCH).days
        d_row, d_hit = self._dim("date_dim", "d_date_sk", self.c("web_sales", "ws_ship_date_sk"))
        day = self.c("date_dim", "d_date")[d_row]
        ca_row, ca_hit = self._dim("customer_address", "ca_address_sk",
                                   self.c("web_sales", "ws_ship_addr_sk"))
        state = code(self.t.vocab("customer_address", "ca_state"), p["STATE"])
        site_row, site_hit = self._dim("web_site", "web_site_sk",
                                       self.c("web_sales", "ws_web_site_sk"))
        company = code(self.t.vocab("web_site", "web_company_name"), p["COMPANY"])
        m = d_hit & (day >= d0) & (day <= d0 + 60) & ca_hit \
            & (self.c("customer_address", "ca_state")[ca_row] == state) & site_hit \
            & (self.c("web_site", "web_company_name")[site_row] == company) \
            & multi[order] & returned[order]
        orders = int(torch.unique(order[m]).numel())
        ship = a.total(self.dec("web_sales", "ws_ext_ship_cost", m))
        profit = a.total(self.dec("web_sales", "ws_net_profit", m))
        return [(orders, a.out(ship), a.out(profit))]

    def q101(self, p):
        a = self.a
        it_row, it_hit = self._dim("item", "i_item_sk", self.c("store_sales", "ss_item_sk"))
        year, d_hit = self._year(self.c("store_sales", "ss_sold_date_sk"))
        cvocab = self.t.vocab("item", "i_category")
        cats = torch.tensor([v in ("Sports", "Books", "Home") for v in cvocab],
                            dtype=torch.bool, device=self.dev)
        m = it_hit & d_hit & (year == 2000) & cats[self.c("item", "i_category")[it_row]]
        rows = it_row[m]
        rev = a.mul(self.dec("store_sales", "ss_list_price", m),
                    a.col(self.c("store_sales", "ss_quantity")[m], 0))
        cat = self.c("item", "i_category")[rows].to(torch.int64)
        iid = self.c("item", "i_item_id")[rows].to(torch.int64)
        gkey, inv = _group([cat, iid])
        if gkey.shape[0] == 0:
            return []
        sums = a.sum_by(rev, inv, gkey.shape[0])
        ckey, cinv = torch.unique(gkey[:, 0], return_inverse=True)
        totals = a.host(a.sum_by(sums, cinv, ckey.numel()))
        perm = lexsort([gkey[:, 0], sums[0], gkey[:, 1]], [False, True, False])[:100]
        ids = self.t.vocab("item", "i_item_id")
        hundred = a.lit("100")
        out = []
        for g, revenue in zip(perm.tolist(), a.host((sums[0][perm], sums[1]))):
            share = a.div(a.mul(revenue, hundred), totals[int(cinv[g])])
            out.append((cvocab[int(gkey[g, 0])], ids[int(gkey[g, 1])], a.out(revenue),
                        a.out(share)))
        return out

    def q102(self, p):
        a = self.a
        s_row, s_hit = self._dim("store", "s_store_sk", self.c("store_sales", "ss_store_sk"))
        it_row, it_hit = self._dim("item", "i_item_sk", self.c("store_sales", "ss_item_sk"))
        m = s_hit & it_hit
        keys = [self.c("store", "s_state")[s_row[m]], self.c("store", "s_store_name")[s_row[m]],
                self.c("item", "i_category")[it_row[m]]]
        gkey, inv = _group(keys)
        if gkey.shape[0] == 0:
            return []
        profit = a.host(a.sum_by(self.dec("store_sales", "ss_net_profit", m), inv,
                                 gkey.shape[0]))
        groups = list(zip(gkey.tolist(), profit))
        # rank() over each state by profit, descending: 1 + the greater profits
        by_state: Dict[int, list] = {}
        for k, x in groups:
            by_state.setdefault(k[0], []).append(x[0])
        for values in by_state.values():
            values.sort()
        rows = []
        for k, x in groups:
            values = by_state[k[0]]
            rk = 1 + len(values) - bisect.bisect_right(values, x[0])
            if rk <= 3:
                rows.append((k, x, rk))
        rows.sort(key=lambda r: (r[0][0], r[2], r[0][1], r[0][2]))
        sv, nv, cv = (self.t.vocab("store", "s_state"), self.t.vocab("store", "s_store_name"),
                      self.t.vocab("item", "i_category"))
        return [(sv[k[0]], nv[k[1]], cv[k[2]], a.out(x), rk) for k, x, rk in rows]

    def q103(self, p):
        a = self.a
        out = []
        # the channels in the ORDER BY's order of their names
        for name, table, date, profit in (
                ("catalog", "catalog_sales", "cs_sold_date_sk", "cs_ext_list_price"),
                ("store", "store_sales", "ss_sold_date_sk", "ss_net_profit"),
                ("web", "web_sales", "ws_sold_date_sk", "ws_net_profit")):
            year, hit = self._year(self.c(table, date))
            m = hit & (year == 2000)
            n = int(m.sum())
            if n:
                out.append((name, n, a.out(a.total(self.dec(table, profit, m)))))
        return out

    def q104(self, p):
        items = torch.cat([self.c("store_sales", "ss_item_sk"), self.c("web_sales", "ws_item_sk"),
                           self.c("catalog_sales", "cs_item_sk")])
        return [(int(torch.unique(items).numel()),)]


def _sorted(rows: List[tuple], order) -> List[tuple]:
    """Rows in the ORDER BY's order (every key ascending here), ties in a
    fixed order."""
    return sorted(rows, key=lambda r: ([_sortable(r[c]) for c, _ in order], repr(r)))


def answers(tables: DsTables, params: Dict[int, Dict], exact: bool = True,
            queries=(64, 95, 101, 102, 103, 104)) -> Dict[int, List[tuple]]:
    """The reference's rows of each query in ``queries`` under ``params``."""
    q = Q(tables, Arith(exact))
    return {n: getattr(q, f"q{n}")(params[n]) for n in queries}


def reference_answers(config: dict, instances: Dict[object, tuple], device) -> Dict:
    """The benchmark's check: the rows of each instance ``key: (query,
    params)``, over tables regenerated at the configuration's scale. No
    product here may run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = Q(DsTables(float(config["scale_factor"]), device), Arith(True))
    return {key: getattr(q, f"q{n}")(p) for key, (n, p) in sorted(
        instances.items(), key=lambda kv: repr(kv[0]))}
