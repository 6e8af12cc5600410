"""The 22 TPC-H queries in plain PyTorch: the benchmark's reference answers.

Each query reads the tables of ``tables.Tables`` (regenerated from the frozen
generator) and the substitution parameters of ``queries/tpch/params.py``, and
returns its rows in the canonical form of ``compare.py``: ints, strings,
``("date", iso)`` and ``("d", unscaled, scale)`` for decimals. Joins are key
lookups (``searchsorted`` over the dimension's sorted keys), groups are
``torch.unique`` inverses, aggregates ``index_add_`` and ``scatter_reduce_``,
string predicates are evaluated once per distinct string. Nothing here imports
the program under test or takes anything it made.
"""
from __future__ import annotations

import datetime
import re
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.arith import Arith
from portbench.reference.compare import canonical, first_difference, same_answer  # noqa: F401
from portbench.reference.tables import Tables

_EPOCH = datetime.date(1970, 1, 1)


# ------------------------------------------------------------------ helpers
def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


def iso(day: int) -> str:
    return (_EPOCH + datetime.timedelta(days=int(day))).isoformat()


def add_months(iso_date: str, months: int) -> int:
    d = datetime.date.fromisoformat(iso_date)
    m = d.year * 12 + d.month - 1 + months
    return (datetime.date(m // 12, m % 12 + 1, d.day) - _EPOCH).days


def like(pattern: str) -> Callable[[str], bool]:
    rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                            for ch in pattern), re.DOTALL)
    return lambda s: rx.fullmatch(s) is not None


def vmask(vocab: List[str], pred, device) -> torch.Tensor:
    """A predicate over a varchar column's distinct strings, by code."""
    return torch.tensor([bool(pred(s)) for s in vocab], dtype=torch.bool, device=device)


def code(vocab: List[str], value: str) -> int:
    """The code of ``value`` in a sorted vocabulary, -1 when absent."""
    i = int(np.searchsorted(np.asarray(vocab), value))
    return i if i < len(vocab) and vocab[i] == value else -1


def lookup(pk: torch.Tensor, fk: torch.Tensor):
    """Row of each foreign key in the table whose unique keys are ``pk``:
    (row index, found)."""
    order = torch.argsort(pk)
    spk = pk[order]
    pos = torch.searchsorted(spk, fk.to(spk.dtype)).clamp_(max=max(len(spk) - 1, 0))
    return order[pos], spk[pos] == fk


def year_of(day: torch.Tensor) -> torch.Tensor:
    lo = days("1990-01-01")
    table = np.array([(_EPOCH + datetime.timedelta(days=d)).year
                      for d in range(lo, days("2001-01-01"))], dtype=np.int64)
    return torch.from_numpy(table).to(day.device)[day.to(torch.int64) - lo]


def lexsort(keys: Sequence[torch.Tensor], desc: Sequence[bool]) -> torch.Tensor:
    """Permutation ordering rows by ``keys`` (first key most significant)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k, d in reversed(list(zip(keys, desc))):
        kk = k[perm]
        perm = perm[torch.argsort(kk, descending=d, stable=True)]
    return perm


class Q:
    """One evaluation of the 22 queries over ``tables`` with ``arith``."""

    def __init__(self, tables: Tables, arith: Arith):
        self.t = tables
        self.a = arith
        self.dev = tables.device

    # shorthand
    def c(self, table, col):
        return self.t.col(table, col)

    def dec(self, table, col):
        return self.a.col(self.t.col(table, col), 2)

    def s(self, table, col, codes) -> List[str]:
        vocab = self.t.vocab(table, col)
        return [vocab[i] for i in codes.tolist()]

    def _nation_names(self) -> List[str]:
        keys = self.c("nation", "n_nationkey").tolist()
        names = self.s("nation", "n_name", self.c("nation", "n_name"))
        out = [""] * (max(keys) + 1)
        for k, n in zip(keys, names):
            out[k] = n
        return out

    def _nation_key(self, name: str) -> int:
        return self._nation_names().index(name)

    def _nations_in_region(self, region: str) -> torch.Tensor:
        """Bool by nation key."""
        rk = self.c("region", "r_regionkey")
        rname = self.c("region", "r_name")
        want = rk[rname == code(self.t.vocab("region", "r_name"), region)]
        nk = self.c("nation", "n_nationkey")
        out = torch.zeros(int(nk.max()) + 1, dtype=torch.bool, device=self.dev)
        out[nk] = torch.isin(self.c("nation", "n_regionkey"), want)
        return out

    def _revenue(self, sel=None):
        ext, disc = self.dec("lineitem", "l_extendedprice"), self.dec("lineitem", "l_discount")
        if sel is not None:
            ext, disc = (ext[0][sel], 2), (disc[0][sel], 2)
        return self.a.mul(ext, self.a.sub(self.a.lit("1"), disc))

    def _pick(self, dec, sel):
        return dec[0][sel], dec[1]

    # ------------------------------------------------------------ queries
    def q1(self, p):
        a = self.a
        ship = self.c("lineitem", "l_shipdate")
        m = ship <= days("1998-12-01") - int(p["DELTA"])
        rf = self.c("lineitem", "l_returnflag")[m].to(torch.int64)
        ls = self.c("lineitem", "l_linestatus")[m].to(torch.int64)
        nls = len(self.t.vocab("lineitem", "l_linestatus"))
        key, inv = torch.unique(rf * nls + ls, return_inverse=True)
        g = key.numel()
        qty = self._pick(self.dec("lineitem", "l_quantity"), m)
        ext = self._pick(self.dec("lineitem", "l_extendedprice"), m)
        disc = self._pick(self.dec("lineitem", "l_discount"), m)
        tax = self._pick(self.dec("lineitem", "l_tax"), m)
        disc_price = a.mul(ext, a.sub(a.lit("1"), disc))
        charge = a.mul(disc_price, a.add(a.lit("1"), tax))
        cnt = torch.bincount(inv, minlength=g).tolist()
        sums = [a.host(a.sum_by(x, inv, g)) for x in (qty, ext, disc_price, charge, disc)]
        rfv, lsv = self.t.vocab("lineitem", "l_returnflag"), self.t.vocab("lineitem", "l_linestatus")
        rows = []
        for i, k in enumerate(key.tolist()):
            sq, se, sd, sc, sdi = (s[i] for s in sums)
            rows.append((rfv[k // nls], lsv[k % nls], a.out(sq), a.out(se), a.out(sd), a.out(sc),
                         a.out(a.avg(sq, cnt[i])), a.out(a.avg(se, cnt[i])),
                         a.out(a.avg(sdi, cnt[i])), cnt[i]))
        return rows

    def q2(self, p):
        a = self.a
        in_region = self._nations_in_region(p["REGION"])
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), self.c("partsupp", "ps_suppkey"))
        ps_ok = s_hit & in_region[self.c("supplier", "s_nationkey")[s_row]]
        pk = self.c("part", "p_partkey")
        p_row, p_hit = lookup(pk, self.c("partsupp", "ps_partkey"))
        ps_ok &= p_hit
        cost = self.dec("partsupp", "ps_supplycost")[0]
        best = torch.full((pk.numel(),), float("inf") if not a.exact else 2 ** 62,
                          dtype=cost.dtype, device=self.dev)
        best.scatter_reduce_(0, p_row[ps_ok], cost[ps_ok], reduce="amin")
        tmask = vmask(self.t.vocab("part", "p_type"), like("%" + p["TYPE"]), self.dev)
        part_ok = (self.c("part", "p_size") == int(p["SIZE"])) & tmask[self.c("part", "p_type")]
        m = ps_ok & part_ok[p_row] & (cost == best[p_row])
        sr, prow = s_row[m], p_row[m]
        acct = self.dec("supplier", "s_acctbal")[0][sr]
        nkey = self.c("supplier", "s_nationkey")[sr]
        names = self._nation_names()
        nname_rank = torch.tensor(np.argsort(np.argsort(np.asarray(names))), device=self.dev)[nkey]
        sname = self.c("supplier", "s_name")[sr]
        pkey = pk[prow]
        perm = lexsort([acct, nname_rank, sname, pkey], [True, False, False, False])[:100]
        sr, prow, nkey = sr[perm], prow[perm], nkey[perm]
        cols = [a.host(self._pick(self.dec("supplier", "s_acctbal"), sr)),
                self.s("supplier", "s_name", self.c("supplier", "s_name")[sr]),
                [names[k] for k in nkey.tolist()], pk[prow].tolist(),
                self.s("part", "p_mfgr", self.c("part", "p_mfgr")[prow]),
                self.s("supplier", "s_address", self.c("supplier", "s_address")[sr]),
                self.s("supplier", "s_phone", self.c("supplier", "s_phone")[sr]),
                self.s("supplier", "s_comment", self.c("supplier", "s_comment")[sr])]
        return [(a.out(r[0]),) + tuple(r[1:]) for r in zip(*cols)]

    def q3(self, p):
        a = self.a
        d = days(p["DATE"])
        seg = self.c("customer", "c_mktsegment") == code(self.t.vocab("customer", "c_mktsegment"),
                                                         p["SEGMENT"])
        c_row, c_hit = lookup(self.c("customer", "c_custkey"), self.c("orders", "o_custkey"))
        o_ok = c_hit & seg[c_row] & (self.c("orders", "o_orderdate") < d)
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey"))
        m = o_hit & o_ok[o_row] & (self.c("lineitem", "l_shipdate") > d)
        okey, inv = torch.unique(self.c("lineitem", "l_orderkey")[m], return_inverse=True)
        rev = a.sum_by(self._revenue(m), inv, okey.numel())
        orow, _ = lookup(self.c("orders", "o_orderkey"), okey)
        odate = self.c("orders", "o_orderdate")[orow]
        perm = lexsort([rev[0], odate], [True, False])[:10]
        prio = self.c("orders", "o_shippriority")[orow[perm]].tolist()
        return [(k, a.out(r), ("date", iso(dd)), sp) for k, r, dd, sp in zip(
            okey[perm].tolist(), a.host((rev[0][perm], rev[1])), odate[perm].tolist(), prio)]

    def q4(self, p):
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 3)
        late = self.c("lineitem", "l_commitdate") < self.c("lineitem", "l_receiptdate")
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey"))
        has = torch.zeros(self.t.rows("orders"), dtype=torch.int64, device=self.dev)
        has.scatter_reduce_(0, o_row[o_hit & late], torch.ones_like(o_row[o_hit & late]),
                            reduce="amax")
        od = self.c("orders", "o_orderdate")
        m = (od >= d0) & (od < d1) & (has > 0)
        prio = self.c("orders", "o_orderpriority")[m].to(torch.int64)
        vocab = self.t.vocab("orders", "o_orderpriority")
        cnt = torch.bincount(prio, minlength=len(vocab)).tolist()
        return [(vocab[i], n) for i, n in enumerate(cnt) if n]

    def q5(self, p):
        a = self.a
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 12)
        in_region = self._nations_in_region(p["REGION"])
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey"))
        od = self.c("orders", "o_orderdate")[o_row]
        c_row, c_hit = lookup(self.c("customer", "c_custkey"), self.c("orders", "o_custkey")[o_row])
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), self.c("lineitem", "l_suppkey"))
        cn = self.c("customer", "c_nationkey")[c_row]
        sn = self.c("supplier", "s_nationkey")[s_row]
        m = o_hit & c_hit & s_hit & (od >= d0) & (od < d1) & (cn == sn) & in_region[sn]
        nkey, inv = torch.unique(sn[m], return_inverse=True)
        rev = a.sum_by(self._revenue(m), inv, nkey.numel())
        names = self._nation_names()
        perm = torch.argsort(rev[0], descending=True, stable=True)
        return [(names[k], a.out(r)) for k, r in zip(nkey[perm].tolist(),
                                                     a.host((rev[0][perm], rev[1])))]

    def q6(self, p):
        a = self.a
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 12)
        ship = self.c("lineitem", "l_shipdate")
        disc = self.dec("lineitem", "l_discount")
        lo = a.sub(a.lit(p["DISCOUNT"]), a.lit("0.01"))
        hi = a.add(a.lit(p["DISCOUNT"]), a.lit("0.01"))
        m = (ship >= d0) & (ship < d1) & a.cmp(disc, lo, ">=") & a.cmp(disc, hi, "<=") \
            & a.cmp(self.dec("lineitem", "l_quantity"), a.lit(str(p["QUANTITY"])), "<")
        rev = a.mul(self._pick(self.dec("lineitem", "l_extendedprice"), m), self._pick(disc, m))
        return [(a.out(a.total(rev)),)]

    def q7(self, p):
        a = self.a
        n1, n2 = self._nation_key(p["NATION1"]), self._nation_key(p["NATION2"])
        ship = self.c("lineitem", "l_shipdate")
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), self.c("lineitem", "l_suppkey"))
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey"))
        c_row, c_hit = lookup(self.c("customer", "c_custkey"), self.c("orders", "o_custkey")[o_row])
        sn = self.c("supplier", "s_nationkey")[s_row]
        cn = self.c("customer", "c_nationkey")[c_row]
        m = s_hit & o_hit & c_hit & (ship >= days("1995-01-01")) & (ship <= days("1996-12-31")) \
            & (((sn == n1) & (cn == n2)) | ((sn == n2) & (cn == n1)))
        yr = year_of(ship[m])
        key, inv = torch.unique((sn[m] * 32 + cn[m]) * 4096 + yr, return_inverse=True)
        rev = a.host(a.sum_by(self._revenue(m), inv, key.numel()))
        names = self._nation_names()
        rows = [(names[k // 4096 // 32], names[k // 4096 % 32], k % 4096, a.out(r))
                for k, r in zip(key.tolist(), rev)]
        return sorted(rows, key=lambda r: (r[0], r[1], r[2]))

    def q8(self, p):
        a = self.a
        in_region = self._nations_in_region(p["REGION"])
        nation = self._nation_key(p["NATION"])
        tmask = self.c("part", "p_type") == code(self.t.vocab("part", "p_type"), p["TYPE"])
        p_row, p_hit = lookup(self.c("part", "p_partkey"), self.c("lineitem", "l_partkey"))
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), self.c("lineitem", "l_suppkey"))
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey"))
        c_row, c_hit = lookup(self.c("customer", "c_custkey"), self.c("orders", "o_custkey")[o_row])
        od = self.c("orders", "o_orderdate")[o_row]
        m = p_hit & s_hit & o_hit & c_hit & tmask[p_row] \
            & in_region[self.c("customer", "c_nationkey")[c_row]] \
            & (od >= days("1995-01-01")) & (od <= days("1996-12-31"))
        yr = year_of(od[m])
        key, inv = torch.unique(yr, return_inverse=True)
        vol = self._revenue(m)
        brazil = (self.c("supplier", "s_nationkey")[s_row][m] == nation)
        part_vol = (vol[0] * brazil.to(vol[0].dtype), vol[1])
        num = a.host(a.sum_by(part_vol, inv, key.numel()))
        den = a.host(a.sum_by(vol, inv, key.numel()))
        return [(y, a.out(a.div(n, d))) for y, n, d in zip(key.tolist(), num, den)]

    def q9(self, p):
        a = self.a
        pmask = vmask(self.t.vocab("part", "p_name"), like(f"%{p['COLOR']}%"), self.dev)
        p_row, p_hit = lookup(self.c("part", "p_partkey"), self.c("lineitem", "l_partkey"))
        m0 = p_hit & pmask[self.c("part", "p_name")[p_row]]
        lpart, lsupp = self.c("lineitem", "l_partkey")[m0], self.c("lineitem", "l_suppkey")[m0]
        ps_key = self.c("partsupp", "ps_partkey") * (1 << 24) + self.c("partsupp", "ps_suppkey")
        ps_row, ps_hit = lookup(ps_key, lpart * (1 << 24) + lsupp)
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), lsupp)
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey")[m0])
        m = ps_hit & s_hit & o_hit
        amount = a.sub(self._pick(self._revenue(m0), m),
                       a.mul((self.dec("partsupp", "ps_supplycost")[0][ps_row[m]], 2),
                             self._pick(self._pick(self.dec("lineitem", "l_quantity"), m0), m)))
        nk = self.c("supplier", "s_nationkey")[s_row[m]]
        yr = year_of(self.c("orders", "o_orderdate")[o_row[m]])
        key, inv = torch.unique(nk * 4096 + yr, return_inverse=True)
        s = a.host(a.sum_by(amount, inv, key.numel()))
        names = self._nation_names()
        rows = [(names[k // 4096], k % 4096, a.out(v)) for k, v in zip(key.tolist(), s)]
        return sorted(rows, key=lambda r: (r[0], -r[1]))

    def q10(self, p):
        a = self.a
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 3)
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey"))
        od = self.c("orders", "o_orderdate")[o_row]
        rflag = self.c("lineitem", "l_returnflag") == code(self.t.vocab("lineitem", "l_returnflag"), "R")
        m = o_hit & (od >= d0) & (od < d1) & rflag
        cust = self.c("orders", "o_custkey")[o_row[m]]
        ckey, inv = torch.unique(cust, return_inverse=True)
        rev = a.sum_by(self._revenue(m), inv, ckey.numel())
        perm = torch.argsort(rev[0], descending=True, stable=True)[:20]
        crow, _ = lookup(self.c("customer", "c_custkey"), ckey[perm])
        names = self._nation_names()
        cols = [ckey[perm].tolist(), self.s("customer", "c_name", self.c("customer", "c_name")[crow]),
                a.host((rev[0][perm], rev[1])),
                a.host(self._pick(self.dec("customer", "c_acctbal"), crow)),
                [names[k] for k in self.c("customer", "c_nationkey")[crow].tolist()],
                self.s("customer", "c_address", self.c("customer", "c_address")[crow]),
                self.s("customer", "c_phone", self.c("customer", "c_phone")[crow]),
                self.s("customer", "c_comment", self.c("customer", "c_comment")[crow])]
        return [(r[0], r[1], a.out(r[2]), a.out(r[3])) + tuple(r[4:]) for r in zip(*cols)]

    def q11(self, p):
        a = self.a
        nation = self._nation_key(p["NATION"])
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), self.c("partsupp", "ps_suppkey"))
        m = s_hit & (self.c("supplier", "s_nationkey")[s_row] == nation)
        value = a.mul(self._pick(self.dec("partsupp", "ps_supplycost"), m),
                      a.col(self.c("partsupp", "ps_availqty")[m], 0))
        total = a.total(value)
        if total[0] is None:
            return []
        pkey, inv = torch.unique(self.c("partsupp", "ps_partkey")[m], return_inverse=True)
        sums = a.sum_by(value, inv, pkey.numel())
        frac = a.lit(p["FRACTION"])
        thresh = a.mul(total, frac)
        keep = a.cmp(sums, thresh, ">")
        perm = torch.nonzero(keep).reshape(-1)
        perm = perm[torch.argsort(sums[0][perm], descending=True, stable=True)]
        return [(k, a.out(v)) for k, v in zip(pkey[perm].tolist(),
                                              a.host((sums[0][perm], sums[1])))]

    def q12(self, p):
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 12)
        modes = self.t.vocab("lineitem", "l_shipmode")
        mode = self.c("lineitem", "l_shipmode")
        want = [code(modes, p["SHIPMODE1"]), code(modes, p["SHIPMODE2"])]
        commit, receipt = self.c("lineitem", "l_commitdate"), self.c("lineitem", "l_receiptdate")
        m = torch.isin(mode, torch.tensor(want, dtype=mode.dtype, device=self.dev)) \
            & (commit < receipt) & (self.c("lineitem", "l_shipdate") < commit) \
            & (receipt >= d0) & (receipt < d1)
        o_row, o_hit = lookup(self.c("orders", "o_orderkey"), self.c("lineitem", "l_orderkey")[m])
        pv = self.t.vocab("orders", "o_orderpriority")
        prio = self.c("orders", "o_orderpriority")[o_row[o_hit]]
        high = (prio == code(pv, "1-URGENT")) | (prio == code(pv, "2-HIGH"))
        lm = mode[m][o_hit].to(torch.int64)
        hi = torch.bincount(lm[high], minlength=len(modes)).tolist()
        lo = torch.bincount(lm[~high], minlength=len(modes)).tolist()
        return [(modes[i], hi[i], lo[i]) for i in range(len(modes)) if hi[i] + lo[i]]

    def q13(self, p):
        cmask = vmask(self.t.vocab("orders", "o_comment"),
                      like(f"%{p['WORD1']}%{p['WORD2']}%"), self.dev)
        keep = ~cmask[self.c("orders", "o_comment")]
        ck = self.c("customer", "c_custkey")
        c_row, c_hit = lookup(ck, self.c("orders", "o_custkey"))
        per = torch.bincount(c_row[keep & c_hit], minlength=ck.numel())
        cnt, dist = torch.unique(per, return_counts=True)
        rows = list(zip(cnt.tolist(), dist.tolist()))
        return sorted(rows, key=lambda r: (-r[1], -r[0]))

    def q14(self, p):
        a = self.a
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 1)
        ship = self.c("lineitem", "l_shipdate")
        p_row, p_hit = lookup(self.c("part", "p_partkey"), self.c("lineitem", "l_partkey"))
        m = p_hit & (ship >= d0) & (ship < d1)
        promo = vmask(self.t.vocab("part", "p_type"), like("PROMO%"), self.dev)[
            self.c("part", "p_type")[p_row[m]]]
        rev = self._revenue(m)
        promo_total = a.total((rev[0] * promo.to(rev[0].dtype), rev[1]))
        if promo_total[0] is None:
            return [(None,)]
        num = a.mul(a.lit("100.00"), promo_total)
        return [(a.out(a.div(num, a.total(rev))),)]

    def q15(self, p):
        a = self.a
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 3)
        ship = self.c("lineitem", "l_shipdate")
        m = (ship >= d0) & (ship < d1)
        skey, inv = torch.unique(self.c("lineitem", "l_suppkey")[m], return_inverse=True)
        rev = a.sum_by(self._revenue(m), inv, skey.numel())
        if skey.numel() == 0:
            return []
        top = rev[0] == rev[0].max()
        keys = skey[top]
        srow, _ = lookup(self.c("supplier", "s_suppkey"), keys)
        cols = [keys.tolist(), self.s("supplier", "s_name", self.c("supplier", "s_name")[srow]),
                self.s("supplier", "s_address", self.c("supplier", "s_address")[srow]),
                self.s("supplier", "s_phone", self.c("supplier", "s_phone")[srow]),
                a.host((rev[0][top], rev[1]))]
        return sorted([r[:4] + (a.out(r[4]),) for r in zip(*cols)], key=lambda r: r[0])

    def q16(self, p):
        bv = self.t.vocab("part", "p_brand")
        tv = self.t.vocab("part", "p_type")
        sizes = torch.tensor([int(p[f"SIZE{i}"]) for i in range(1, 9)], device=self.dev)
        tmask = ~vmask(tv, like(p["TYPE"] + "%"), self.dev)
        pb, pt, psz = self.c("part", "p_brand"), self.c("part", "p_type"), self.c("part", "p_size")
        part_ok = (pb != code(bv, p["BRAND"])) & tmask[pt] & torch.isin(psz, sizes.to(psz.dtype))
        smask = vmask(self.t.vocab("supplier", "s_comment"), like("%Customer%Complaints%"), self.dev)
        bad = self.c("supplier", "s_suppkey")[smask[self.c("supplier", "s_comment")]]
        p_row, p_hit = lookup(self.c("part", "p_partkey"), self.c("partsupp", "ps_partkey"))
        supp = self.c("partsupp", "ps_suppkey")
        m = p_hit & part_ok[p_row] & ~torch.isin(supp, bad)
        pr = p_row[m]
        gkey = (pb[pr].to(torch.int64) * len(tv) + pt[pr].to(torch.int64)) * 64 + psz[pr].to(torch.int64)
        key, inv = torch.unique(gkey, return_inverse=True)
        pair = torch.unique(inv * (1 << 24) + supp[m])
        cnt = torch.bincount(pair // (1 << 24), minlength=key.numel()).tolist()
        rows = [(bv[k // 64 // len(tv)], tv[k // 64 % len(tv)], k % 64, n)
                for k, n in zip(key.tolist(), cnt)]
        return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))

    def q17(self, p):
        a = self.a
        bm = self.c("part", "p_brand") == code(self.t.vocab("part", "p_brand"), p["BRAND"])
        cm = self.c("part", "p_container") == code(self.t.vocab("part", "p_container"), p["CONTAINER"])
        pk = self.c("part", "p_partkey")
        p_row, p_hit = lookup(pk, self.c("lineitem", "l_partkey"))
        n = pk.numel()
        qty = self.dec("lineitem", "l_quantity")
        sums = a.sum_by(self._pick(qty, p_hit), p_row[p_hit], n)
        cnt = torch.bincount(p_row[p_hit], minlength=n)
        avg = a.avg_t(sums, cnt)
        limit = a.mul(a.lit("0.2"), avg)
        sel = p_hit & (bm & cm)[p_row]
        lim = (limit[0][p_row[sel]], limit[1])
        m = a.cmp(self._pick(qty, sel), lim, "<")
        ext = self._pick(self._pick(self.dec("lineitem", "l_extendedprice"), sel), m)
        return [(a.out(a.div(a.total(ext), a.lit("7.0"))),)]

    def q18(self, p):
        a = self.a
        ok = self.c("orders", "o_orderkey")
        o_row, o_hit = lookup(ok, self.c("lineitem", "l_orderkey"))
        qty = self.dec("lineitem", "l_quantity")
        per = a.sum_by(self._pick(qty, o_hit), o_row[o_hit], ok.numel())
        big = torch.nonzero(a.cmp(per, a.lit(str(p["QUANTITY"])), ">")).reshape(-1)
        price = self.dec("orders", "o_totalprice")[0][big]
        odate = self.c("orders", "o_orderdate")[big]
        perm = lexsort([price, odate], [True, False])[:100]
        rows_ = big[perm]
        c_row, _ = lookup(self.c("customer", "c_custkey"), self.c("orders", "o_custkey")[rows_])
        cols = [self.s("customer", "c_name", self.c("customer", "c_name")[c_row]),
                self.c("customer", "c_custkey")[c_row].tolist(), ok[rows_].tolist(),
                self.c("orders", "o_orderdate")[rows_].tolist(),
                a.host(self._pick(self.dec("orders", "o_totalprice"), rows_)),
                a.host((per[0][rows_], per[1]))]
        return [(r[0], r[1], r[2], ("date", iso(r[3])), a.out(r[4]), a.out(r[5]))
                for r in zip(*cols)]

    def q19(self, p):
        a = self.a
        p_row, p_hit = lookup(self.c("part", "p_partkey"), self.c("lineitem", "l_partkey"))
        modes = self.t.vocab("lineitem", "l_shipmode")
        mode_ok = torch.isin(self.c("lineitem", "l_shipmode"),
                             torch.tensor([code(modes, m) for m in ("AIR", "AIR REG")],
                                          device=self.dev).to(self.c("lineitem", "l_shipmode").dtype))
        instr = self.c("lineitem", "l_shipinstruct") == code(
            self.t.vocab("lineitem", "l_shipinstruct"), "DELIVER IN PERSON")
        base = p_hit & mode_ok & instr
        brand = self.c("part", "p_brand")[p_row]
        cont = self.c("part", "p_container")[p_row]
        size = self.c("part", "p_size")[p_row]
        qty = self.dec("lineitem", "l_quantity")
        bv, cv = self.t.vocab("part", "p_brand"), self.t.vocab("part", "p_container")
        m = torch.zeros_like(base)
        for b, prefix, q, smax in ((p["BRAND1"], "SM", p["QUANTITY1"], 5),
                                   (p["BRAND2"], "MED", p["QUANTITY2"], 10),
                                   (p["BRAND3"], "LG", p["QUANTITY3"], 15)):
            conts = torch.tensor([code(cv, f"{prefix} {c}") for c in
                                  (("CASE", "BOX", "PACK", "PKG") if prefix != "MED"
                                   else ("BAG", "BOX", "PKG", "PACK"))], device=self.dev)
            m |= (brand == code(bv, b)) & torch.isin(cont, conts.to(cont.dtype)) \
                & a.cmp(qty, a.lit(str(q)), ">=") & a.cmp(qty, a.lit(str(int(q) + 10)), "<=") \
                & (size >= 1) & (size <= smax)
        m &= base
        return [(a.out(a.total(self._revenue(m))),)]

    def q20(self, p):
        a = self.a
        d0, d1 = days(p["DATE"]), add_months(p["DATE"], 12)
        nation = self._nation_key(p["NATION"])
        pmask = vmask(self.t.vocab("part", "p_name"), like(p["COLOR"] + "%"), self.dev)
        parts = self.c("part", "p_partkey")[pmask[self.c("part", "p_name")]]
        ship = self.c("lineitem", "l_shipdate")
        lm = (ship >= d0) & (ship < d1) & torch.isin(self.c("lineitem", "l_partkey"), parts)
        lkey = self.c("lineitem", "l_partkey")[lm] * (1 << 24) + self.c("lineitem", "l_suppkey")[lm]
        key, inv = torch.unique(lkey, return_inverse=True)
        sums = a.sum_by(self._pick(self.dec("lineitem", "l_quantity"), lm), inv, key.numel())
        ps_part, ps_supp = self.c("partsupp", "ps_partkey"), self.c("partsupp", "ps_suppkey")
        psm = torch.isin(ps_part, parts)
        k_row, k_hit = lookup(key, ps_part[psm] * (1 << 24) + ps_supp[psm])
        half = a.mul(a.lit("0.5"), (sums[0][k_row], sums[1]))
        avail = a.col(self.c("partsupp", "ps_availqty")[psm], 0)
        ok = k_hit & a.cmp(avail, half, ">")
        supp = torch.unique(ps_supp[psm][ok])
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), supp)
        s_row = s_row[s_hit & (self.c("supplier", "s_nationkey")[s_row] == nation)]
        rows = list(zip(self.s("supplier", "s_name", self.c("supplier", "s_name")[s_row]),
                        self.s("supplier", "s_address", self.c("supplier", "s_address")[s_row])))
        return sorted(rows)

    def q21(self, p):
        nation = self._nation_key(p["NATION"])
        lok, lsupp = self.c("lineitem", "l_orderkey"), self.c("lineitem", "l_suppkey")
        late = self.c("lineitem", "l_receiptdate") > self.c("lineitem", "l_commitdate")
        ok = self.c("orders", "o_orderkey")
        o_row, o_hit = lookup(ok, lok)
        n = ok.numel()
        big = torch.iinfo(torch.int64).max

        def spread(mask):
            lo = torch.full((n,), big, dtype=torch.int64, device=self.dev)
            hi = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
            lo.scatter_reduce_(0, o_row[mask], lsupp[mask], reduce="amin")
            hi.scatter_reduce_(0, o_row[mask], lsupp[mask], reduce="amax")
            return lo, hi

        all_lo, all_hi = spread(o_hit)
        late_lo, late_hi = spread(o_hit & late)
        status_f = self.c("orders", "o_orderstatus") == code(self.t.vocab("orders", "o_orderstatus"), "F")
        s_row, s_hit = lookup(self.c("supplier", "s_suppkey"), lsupp)
        m = o_hit & s_hit & late & status_f[o_row] \
            & (self.c("supplier", "s_nationkey")[s_row] == nation) \
            & (all_lo[o_row] != all_hi[o_row]) & (late_lo[o_row] == late_hi[o_row])
        sk, cnt = torch.unique(lsupp[m], return_counts=True)
        srow, _ = lookup(self.c("supplier", "s_suppkey"), sk)
        rows = list(zip(self.s("supplier", "s_name", self.c("supplier", "s_name")[srow]),
                        cnt.tolist()))
        return sorted(rows, key=lambda r: (-r[1], r[0]))[:100]

    def q22(self, p):
        a = self.a
        codes = [p[f"I{i}"] for i in range(1, 8)]
        phones = self.t.vocab("customer", "c_phone")
        cc = torch.tensor([int(ph[:2]) if ph[:2] in codes else -1 for ph in phones],
                          device=self.dev)[self.c("customer", "c_phone")]
        bal = self.dec("customer", "c_acctbal")
        in_set = cc >= 0
        pos = in_set & a.cmp(bal, a.lit("0.00"), ">")
        avg = a.avg(a.total(self._pick(bal, pos)), int(pos.sum()))
        if avg[0] is None:
            return []
        ck = self.c("customer", "c_custkey")
        c_row, c_hit = lookup(ck, self.c("orders", "o_custkey"))
        has = torch.bincount(c_row[c_hit], minlength=ck.numel()) > 0
        m = in_set & a.cmp(bal, avg, ">") & ~has
        key, inv = torch.unique(cc[m], return_inverse=True)
        sums = a.host(a.sum_by(self._pick(bal, m), inv, key.numel()))
        cnt = torch.bincount(inv, minlength=key.numel()).tolist()
        return [(str(k), n, a.out(s)) for k, n, s in zip(key.tolist(), cnt, sums)]


def answers(tables: Tables, params: Dict[int, Dict], exact: bool = True,
            queries=range(1, 23)) -> Dict[int, List[tuple]]:
    """The reference's rows of each query in ``queries`` under ``params``."""
    q = Q(tables, Arith(exact))
    return {n: getattr(q, f"q{n}")(params[n]) for n in queries}


def reference_answers(config: dict, instances: Dict[object, tuple], device) -> Dict:
    """The benchmark's check: the rows of each instance ``key: (query,
    params)``, over tables regenerated at the configuration's scale."""
    q = Q(Tables(float(config["scale_factor"]), device), Arith(True))
    return {key: getattr(q, f"q{n}")(p) for key, (n, p) in sorted(
        instances.items(), key=lambda kv: repr(kv[0]))}
