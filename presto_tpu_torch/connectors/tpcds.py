"""TPC-DS connector: deterministic in-memory data generation.

The port's copy of presto_tpu/connectors/tpcds.py: the generation is
verbatim, only the imports point into presto_tpu_torch, so the tables are
bit-identical to the JAX package's (tests/test_torch_tpcds.py).

Reference role: presto-tpcds (presto-tpcds/src/main/java/com/facebook/
presto/tpcds/ — the second standard fixture connector; BASELINE.json names
the TPC-DS 99-query suite as a target harness, SURVEY.md §6).

Like the TPC-H generator (connectors/tpch.py), this is *spec-shaped*, not
bit-identical to dsdgen: table row-count ratios, surrogate-key ranges
(date_sk = julian day), dimension cross-products (customer/household
demographics), fact->dimension FK relationships, NULLable FK columns and
value distributions follow the TPC-DS spec so query selectivities are
realistic; exact values differ. Correctness tests compare against a
sqlite oracle over the SAME generated data.

Fixed-cardinality dimensions (date_dim 1900..2100, time_dim 86400,
demographics cross-products) are scale-independent, as in the spec; fact
tables scale with `scale_factor` (≈GB)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch.connectors.tpch import HostTable, _slice_rows
from presto_tpu_torch.data.column import StringDict
from presto_tpu_torch.expr.compile import days_from_civil
from presto_tpu_torch.types import BIGINT, DATE, DOUBLE, INTEGER, VARCHAR, Type

# ---------------------------------------------------------------------------
# schema (column subset used by the implemented query set; same layout
# conventions as the reference's tpcds tables)
# ---------------------------------------------------------------------------

TPCDS_SCHEMA: Dict[str, List[Tuple[str, Type]]] = {
    "date_dim": [
        ("d_date_sk", BIGINT), ("d_date_id", VARCHAR), ("d_date", DATE),
        ("d_month_seq", INTEGER), ("d_week_seq", INTEGER),
        ("d_quarter_seq", INTEGER), ("d_year", INTEGER), ("d_dow", INTEGER),
        ("d_moy", INTEGER), ("d_dom", INTEGER), ("d_qoy", INTEGER),
        ("d_day_name", VARCHAR),
        ("d_quarter_name", VARCHAR),
    ],
    "time_dim": [
        ("t_time_sk", BIGINT), ("t_time", INTEGER), ("t_hour", INTEGER),
        ("t_minute", INTEGER), ("t_second", INTEGER),
        ("t_meal_time", VARCHAR),
    ],
    "item": [
        ("i_item_sk", BIGINT), ("i_item_id", VARCHAR),
        ("i_item_desc", VARCHAR), ("i_current_price", DOUBLE),
        ("i_wholesale_cost", DOUBLE),
        ("i_brand_id", INTEGER), ("i_brand", VARCHAR),
        ("i_class_id", INTEGER), ("i_class", VARCHAR),
        ("i_category_id", INTEGER), ("i_category", VARCHAR),
        ("i_manufact_id", INTEGER), ("i_manufact", VARCHAR),
        ("i_manager_id", INTEGER), ("i_color", VARCHAR),
        ("i_units", VARCHAR), ("i_size", VARCHAR),
        ("i_product_name", VARCHAR),
    ],
    "store": [
        ("s_store_sk", BIGINT), ("s_store_id", VARCHAR),
        ("s_store_name", VARCHAR), ("s_number_employees", INTEGER),
        ("s_hours", VARCHAR), ("s_manager", VARCHAR),
        ("s_market_id", INTEGER), ("s_company_id", INTEGER),
        ("s_company_name", VARCHAR),
        ("s_city", VARCHAR), ("s_county", VARCHAR), ("s_state", VARCHAR),
        ("s_zip", VARCHAR), ("s_gmt_offset", DOUBLE),
    ],
    "warehouse": [
        ("w_warehouse_sk", BIGINT), ("w_warehouse_name", VARCHAR),
        ("w_warehouse_sq_ft", INTEGER), ("w_state", VARCHAR),
        ("w_country", VARCHAR),
    ],
    "promotion": [
        ("p_promo_sk", BIGINT), ("p_promo_id", VARCHAR),
        ("p_channel_dmail", VARCHAR), ("p_channel_email", VARCHAR),
        ("p_channel_tv", VARCHAR), ("p_channel_event", VARCHAR),
    ],
    "customer": [
        ("c_customer_sk", BIGINT), ("c_customer_id", VARCHAR),
        ("c_current_cdemo_sk", BIGINT), ("c_current_hdemo_sk", BIGINT),
        ("c_current_addr_sk", BIGINT), ("c_salutation", VARCHAR),
        ("c_first_name", VARCHAR),
        ("c_last_name", VARCHAR), ("c_preferred_cust_flag", VARCHAR),
        ("c_birth_day", INTEGER), ("c_birth_month", INTEGER),
        ("c_birth_year", INTEGER),
        ("c_birth_country", VARCHAR), ("c_login", VARCHAR),
        ("c_email_address", VARCHAR),
        ("c_last_review_date_sk", BIGINT),
    ],
    "customer_address": [
        ("ca_address_sk", BIGINT), ("ca_address_id", VARCHAR),
        ("ca_city", VARCHAR), ("ca_county", VARCHAR), ("ca_state", VARCHAR),
        ("ca_zip", VARCHAR), ("ca_country", VARCHAR),
        ("ca_gmt_offset", DOUBLE), ("ca_location_type", VARCHAR),
    ],
    "customer_demographics": [
        ("cd_demo_sk", BIGINT), ("cd_gender", VARCHAR),
        ("cd_marital_status", VARCHAR), ("cd_education_status", VARCHAR),
        ("cd_purchase_estimate", INTEGER), ("cd_credit_rating", VARCHAR),
        ("cd_dep_count", INTEGER), ("cd_dep_employed_count", INTEGER),
        ("cd_dep_college_count", INTEGER),
    ],
    "household_demographics": [
        ("hd_demo_sk", BIGINT), ("hd_income_band_sk", BIGINT),
        ("hd_buy_potential", VARCHAR), ("hd_dep_count", INTEGER),
        ("hd_vehicle_count", INTEGER),
    ],
    "store_sales": [
        ("ss_sold_date_sk", BIGINT), ("ss_sold_time_sk", BIGINT),
        ("ss_item_sk", BIGINT), ("ss_customer_sk", BIGINT),
        ("ss_cdemo_sk", BIGINT), ("ss_hdemo_sk", BIGINT),
        ("ss_addr_sk", BIGINT), ("ss_store_sk", BIGINT),
        ("ss_promo_sk", BIGINT), ("ss_ticket_number", BIGINT),
        ("ss_quantity", INTEGER), ("ss_wholesale_cost", DOUBLE),
        ("ss_list_price", DOUBLE), ("ss_sales_price", DOUBLE),
        ("ss_ext_discount_amt", DOUBLE), ("ss_ext_sales_price", DOUBLE),
        ("ss_ext_wholesale_cost", DOUBLE), ("ss_ext_list_price", DOUBLE),
        ("ss_ext_tax", DOUBLE),
        ("ss_coupon_amt", DOUBLE), ("ss_net_paid", DOUBLE),
        ("ss_net_profit", DOUBLE),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", BIGINT), ("cs_sold_time_sk", BIGINT),
        ("cs_ship_date_sk", BIGINT), ("cs_bill_customer_sk", BIGINT),
        ("cs_bill_cdemo_sk", BIGINT), ("cs_bill_addr_sk", BIGINT),
        ("cs_ship_addr_sk", BIGINT), ("cs_ship_customer_sk", BIGINT),
        ("cs_warehouse_sk", BIGINT), ("cs_ship_mode_sk", BIGINT),
        ("cs_call_center_sk", BIGINT),
        ("cs_item_sk", BIGINT), ("cs_promo_sk", BIGINT),
        ("cs_order_number", BIGINT), ("cs_quantity", INTEGER),
        ("cs_wholesale_cost", DOUBLE), ("cs_list_price", DOUBLE),
        ("cs_sales_price", DOUBLE), ("cs_ext_discount_amt", DOUBLE),
        ("cs_ext_sales_price", DOUBLE),
        ("cs_ext_wholesale_cost", DOUBLE),
        ("cs_ext_list_price", DOUBLE), ("cs_ext_ship_cost", DOUBLE),
        ("cs_coupon_amt", DOUBLE), ("cs_net_paid", DOUBLE),
        ("cs_net_profit", DOUBLE),
    ],
    "web_sales": [
        ("ws_sold_date_sk", BIGINT), ("ws_sold_time_sk", BIGINT),
        ("ws_ship_date_sk", BIGINT), ("ws_item_sk", BIGINT),
        ("ws_bill_customer_sk", BIGINT),
        ("ws_ship_customer_sk", BIGINT), ("ws_bill_addr_sk", BIGINT),
        ("ws_ship_addr_sk", BIGINT), ("ws_warehouse_sk", BIGINT),
        ("ws_ship_mode_sk", BIGINT), ("ws_ship_hdemo_sk", BIGINT),
        ("ws_web_page_sk", BIGINT),
        ("ws_web_site_sk", BIGINT), ("ws_promo_sk", BIGINT),
        ("ws_order_number", BIGINT), ("ws_quantity", INTEGER),
        ("ws_wholesale_cost", DOUBLE), ("ws_list_price", DOUBLE),
        ("ws_sales_price", DOUBLE), ("ws_ext_discount_amt", DOUBLE),
        ("ws_ext_sales_price", DOUBLE),
        ("ws_ext_wholesale_cost", DOUBLE),
        ("ws_ext_list_price", DOUBLE),
        ("ws_ext_ship_cost", DOUBLE),
        ("ws_net_paid", DOUBLE), ("ws_net_profit", DOUBLE),
    ],
    "inventory": [
        ("inv_date_sk", BIGINT), ("inv_item_sk", BIGINT),
        ("inv_warehouse_sk", BIGINT), ("inv_quantity_on_hand", INTEGER),
    ],
    "store_returns": [
        ("sr_returned_date_sk", BIGINT), ("sr_return_time_sk", BIGINT),
        ("sr_item_sk", BIGINT), ("sr_customer_sk", BIGINT),
        ("sr_cdemo_sk", BIGINT), ("sr_hdemo_sk", BIGINT),
        ("sr_addr_sk", BIGINT), ("sr_store_sk", BIGINT),
        ("sr_reason_sk", BIGINT), ("sr_ticket_number", BIGINT),
        ("sr_return_quantity", INTEGER), ("sr_return_amt", DOUBLE),
        ("sr_return_tax", DOUBLE), ("sr_return_amt_inc_tax", DOUBLE),
        ("sr_fee", DOUBLE), ("sr_return_ship_cost", DOUBLE),
        ("sr_refunded_cash", DOUBLE), ("sr_reversed_charge", DOUBLE),
        ("sr_store_credit", DOUBLE), ("sr_net_loss", DOUBLE),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", BIGINT), ("cr_returned_time_sk", BIGINT),
        ("cr_item_sk", BIGINT), ("cr_refunded_customer_sk", BIGINT),
        ("cr_returning_customer_sk", BIGINT),
        ("cr_returning_addr_sk", BIGINT), ("cr_call_center_sk", BIGINT),
        ("cr_catalog_page_sk", BIGINT), ("cr_reason_sk", BIGINT),
        ("cr_order_number", BIGINT), ("cr_return_quantity", INTEGER),
        ("cr_return_amount", DOUBLE), ("cr_return_tax", DOUBLE),
        ("cr_fee", DOUBLE), ("cr_return_ship_cost", DOUBLE),
        ("cr_refunded_cash", DOUBLE), ("cr_reversed_charge", DOUBLE),
        ("cr_store_credit", DOUBLE), ("cr_net_loss", DOUBLE),
    ],
    "web_returns": [
        ("wr_returned_date_sk", BIGINT), ("wr_returned_time_sk", BIGINT),
        ("wr_item_sk", BIGINT), ("wr_refunded_customer_sk", BIGINT),
        ("wr_refunded_cdemo_sk", BIGINT), ("wr_refunded_addr_sk", BIGINT),
        ("wr_returning_customer_sk", BIGINT),
        ("wr_returning_cdemo_sk", BIGINT),
        ("wr_returning_addr_sk", BIGINT), ("wr_web_page_sk", BIGINT),
        ("wr_reason_sk", BIGINT), ("wr_order_number", BIGINT),
        ("wr_return_quantity", INTEGER), ("wr_return_amt", DOUBLE),
        ("wr_return_tax", DOUBLE), ("wr_fee", DOUBLE),
        ("wr_return_ship_cost", DOUBLE), ("wr_refunded_cash", DOUBLE),
        ("wr_reversed_charge", DOUBLE), ("wr_account_credit", DOUBLE),
        ("wr_net_loss", DOUBLE),
    ],
    "reason": [
        ("r_reason_sk", BIGINT), ("r_reason_id", VARCHAR),
        ("r_reason_desc", VARCHAR),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", BIGINT), ("sm_ship_mode_id", VARCHAR),
        ("sm_type", VARCHAR), ("sm_code", VARCHAR),
        ("sm_carrier", VARCHAR),
    ],
    "income_band": [
        ("ib_income_band_sk", BIGINT), ("ib_lower_bound", INTEGER),
        ("ib_upper_bound", INTEGER),
    ],
    "web_page": [
        ("wp_web_page_sk", BIGINT), ("wp_web_page_id", VARCHAR),
        ("wp_url", VARCHAR), ("wp_type", VARCHAR),
        ("wp_char_count", INTEGER), ("wp_link_count", INTEGER),
    ],
    "web_site": [
        ("web_site_sk", BIGINT), ("web_site_id", VARCHAR),
        ("web_name", VARCHAR), ("web_manager", VARCHAR),
        ("web_company_name", VARCHAR), ("web_gmt_offset", DOUBLE),
    ],
    "call_center": [
        ("cc_call_center_sk", BIGINT), ("cc_call_center_id", VARCHAR),
        ("cc_name", VARCHAR), ("cc_manager", VARCHAR),
        ("cc_county", VARCHAR),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", BIGINT), ("cp_catalog_page_id", VARCHAR),
        ("cp_department", VARCHAR), ("cp_type", VARCHAR),
    ],
}

_D0 = days_from_civil(1900, 1, 1)
_D1 = days_from_civil(2100, 1, 1)
_DATE_SK0 = 2415022                       # julian day of 1900-01-01
_N_DATES = _D1 - _D0                      # 73049 rows, per spec
                                          # (1900-01-01 .. 2099-12-31)

_SALES_D0 = days_from_civil(1998, 1, 1)
_SALES_D1 = days_from_civil(2002, 12, 31)

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_CLASSES_PER_CAT = 10
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]
_STATES = ["AL", "CA", "CO", "FL", "GA", "IL", "IN", "KS", "KY", "LA",
           "MI", "MN", "MO", "NC", "NE", "NY", "OH", "OK", "OR", "PA",
           "SD", "TN", "TX", "VA", "WA", "WI"]
_COUNTIES = ["Ziebach County", "Walker County", "Daviess County",
             "Barrow County", "Fairfield County", "Luce County",
             "Richland County", "Bronx County", "Orange County",
             "Williamson County"]
_CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
           "Liberty", "Oakland", "Riverside", "Glendale", "Springdale",
           "Union", "Salem", "Greenfield", "Pleasant Hill", "Lakeview"]
_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                  "0-500", "Unknown"]
_CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_MARITAL = ["M", "S", "D", "W", "U"]
_COLORS = ["slate", "blanched", "burnished", "peach", "saddle", "navy",
           "salmon", "powder", "metallic", "smoke", "misty", "frosted",
           "aquamarine", "dodger", "chiffon", "rose", "beige", "pale"]
_SIZES = ["small", "medium", "large", "extra large", "economy", "N/A",
          "petite"]
_UNITS = ["Ounce", "Oz", "Bunch", "Ton", "N/A", "Dozen", "Box", "Pound",
          "Pallet", "Gross", "Cup", "Dram", "Each", "Tbl", "Lb",
          "Bundle", "Case", "Carton"]
_MEALS = ["breakfast", "lunch", "dinner", ""]
_COUNTRIES = ["United States"]
_FIRST = ["James", "Mary", "John", "Linda", "Robert", "Susan", "Michael",
          "Karen", "William", "Lisa", "David", "Nancy", "Richard", "Betty"]
_LAST = ["Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
         "Miller", "Davis", "Wilson", "Anderson", "Taylor", "Thomas"]

# spec row counts at SF1; fact tables scale linearly, dims sub-linearly
_SF1 = {"store_sales": 2_880_000, "catalog_sales": 1_440_000,
        "web_sales": 720_000, "item": 18_000, "customer": 100_000,
        "customer_address": 50_000, "store": 12, "warehouse": 5,
        "promotion": 300}


def _counts(sf: float) -> Dict[str, int]:
    def lin(base, floor):
        return max(floor, int(base * sf))
    return {
        "store_sales": lin(_SF1["store_sales"], 1000),
        "catalog_sales": lin(_SF1["catalog_sales"], 500),
        "web_sales": lin(_SF1["web_sales"], 250),
        "item": lin(_SF1["item"], 200),
        "customer": lin(_SF1["customer"], 300),
        "customer_address": lin(_SF1["customer_address"], 150),
        "store": max(4, int(_SF1["store"] * max(sf, 0.4))),
        "warehouse": max(3, int(_SF1["warehouse"] * max(sf, 0.6))),
        "promotion": lin(_SF1["promotion"], 30),
    }


def _seed(name: str, sf: float) -> int:
    import zlib
    return zlib.crc32(f"tpcds|{name}|{sf}".encode())


def _dictify(arrays, dicts, col, vals):
    d, codes = StringDict.build(vals)
    arrays[col], dicts[col] = codes, d


def _ht(name, n, arrays, dicts, nulls=None) -> HostTable:
    return HostTable(name, n, arrays, dict(TPCDS_SCHEMA[name]), dicts,
                     nulls)


@functools.lru_cache(maxsize=64)
def _gen(name: str, sf: float) -> HostTable:
    c = _counts(sf)
    rng = np.random.default_rng(_seed(name, sf))
    arrays: Dict[str, np.ndarray] = {}
    dicts: Dict[str, StringDict] = {}

    def put_str(col, vals):
        _dictify(arrays, dicts, col, vals)

    if name == "date_dim":
        days = np.arange(_D0, _D1, dtype=np.int64)
        n = len(days)
        arrays["d_date_sk"] = _DATE_SK0 + (days - _D0)
        put_str("d_date_id", np.char.add(
            "D", (_DATE_SK0 + days - _D0).astype(str)).astype(object))
        arrays["d_date"] = days.astype(np.int32)
        # civil fields via numpy datetime64 (exact)
        dt = (days.astype("datetime64[D]"))
        y = dt.astype("datetime64[Y]").astype(int) + 1970
        m = dt.astype("datetime64[M]").astype(int) % 12 + 1
        dom = (dt - dt.astype("datetime64[M]")).astype(int) + 1
        arrays["d_year"] = y.astype(np.int32)
        arrays["d_moy"] = m.astype(np.int32)
        arrays["d_dom"] = dom.astype(np.int32)
        arrays["d_qoy"] = ((m - 1) // 3 + 1).astype(np.int32)
        # 1900-01-01 was a Monday; spec d_dow: 0=Sunday
        dow = ((days - _D0) + 1) % 7
        arrays["d_dow"] = dow.astype(np.int32)
        put_str("d_day_name",
                np.asarray(_DAY_NAMES, dtype=object)[dow])
        put_str("d_quarter_name", np.char.add(
            np.char.add(y.astype(str), "Q"),
            ((m - 1) // 3 + 1).astype(str)).astype(object))
        arrays["d_month_seq"] = ((y - 1900) * 12 + (m - 1)).astype(np.int32)
        arrays["d_week_seq"] = ((days - _D0) // 7 + 1).astype(np.int32)
        arrays["d_quarter_seq"] = ((y - 1900) * 4 + (m - 1) // 3 + 1
                                   ).astype(np.int32)
        return _ht(name, n, arrays, dicts)

    if name == "time_dim":
        t = np.arange(86400, dtype=np.int64)
        arrays["t_time_sk"] = t
        arrays["t_time"] = t.astype(np.int32)
        hour = (t // 3600).astype(np.int32)
        arrays["t_hour"] = hour
        arrays["t_minute"] = ((t % 3600) // 60).astype(np.int32)
        arrays["t_second"] = (t % 60).astype(np.int32)
        meal = np.where(hour < 9, "breakfast",
                        np.where(hour < 14, "lunch",
                                 np.where(hour < 22, "dinner", "")))
        put_str("t_meal_time", meal.astype(object))
        return _ht(name, 86400, arrays, dicts)

    if name == "item":
        n = c["item"]
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["i_item_sk"] = sk
        put_str("i_item_id", np.char.add("AAAAAAAA",
                np.char.zfill(sk.astype(str), 8)).astype(object))
        put_str("i_item_desc", np.char.add("item description ",
                (sk % 997).astype(str)).astype(object))
        arrays["i_current_price"] = np.round(
            rng.uniform(0.09, 99.99, size=n), 2)
        arrays["i_wholesale_cost"] = np.round(
            arrays["i_current_price"] * rng.uniform(0.4, 0.8, size=n), 2)
        cat_id = rng.integers(1, len(_CATEGORIES) + 1, size=n)
        arrays["i_category_id"] = cat_id.astype(np.int32)
        put_str("i_category",
                np.asarray(_CATEGORIES, dtype=object)[cat_id - 1])
        class_id = rng.integers(1, _CLASSES_PER_CAT + 1, size=n)
        arrays["i_class_id"] = class_id.astype(np.int32)
        put_str("i_class", np.char.add(
            np.char.add(np.asarray(_CATEGORIES)[cat_id - 1].astype(str),
                        " class "),
            class_id.astype(str)).astype(object))
        brand_id = (cat_id * 1000000 + class_id * 10000
                    + rng.integers(1, 100, size=n)).astype(np.int32)
        arrays["i_brand_id"] = brand_id
        put_str("i_brand", np.char.add("brand#",
                brand_id.astype(str)).astype(object))
        man_id = rng.integers(1, 1001, size=n)
        arrays["i_manufact_id"] = man_id.astype(np.int32)
        put_str("i_manufact", np.char.add("manufact#",
                man_id.astype(str)).astype(object))
        arrays["i_manager_id"] = rng.integers(
            1, 101, size=n).astype(np.int32)
        put_str("i_color", np.asarray(_COLORS, dtype=object)[
            rng.integers(0, len(_COLORS), size=n)])
        put_str("i_units", np.asarray(_UNITS, dtype=object)[
            rng.integers(0, len(_UNITS), size=n)])
        put_str("i_size", np.asarray(_SIZES, dtype=object)[
            rng.integers(0, len(_SIZES), size=n)])
        put_str("i_product_name", np.char.add("product",
                np.char.zfill(sk.astype(str), 7)).astype(object))
        return _ht(name, n, arrays, dicts)

    if name == "store":
        n = c["store"]
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["s_store_sk"] = sk
        put_str("s_store_id", np.char.add("S", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        put_str("s_store_name", np.asarray(
            ["ought", "able", "pri", "ese", "anti", "cally", "ation",
             "eing", "n st", "bar", "ought2", "able2"],
            dtype=object)[(sk - 1) % 12])
        arrays["s_number_employees"] = rng.integers(
            200, 301, size=n).astype(np.int32)
        put_str("s_hours", np.asarray(["8AM-8AM", "8AM-4PM", "8AM-12AM"],
                                      dtype=object)[(sk - 1) % 3])
        put_str("s_manager", np.asarray(_FIRST, dtype=object)[
            rng.integers(0, len(_FIRST), size=n)])
        arrays["s_market_id"] = rng.integers(1, 11, size=n).astype(np.int32)
        arrays["s_company_id"] = np.ones(n, dtype=np.int32)
        put_str("s_company_name", np.asarray(["Unknown"], dtype=object)[
            np.zeros(n, dtype=np.int64)])
        put_str("s_city", np.asarray(_CITIES, dtype=object)[
            rng.integers(0, len(_CITIES), size=n)])
        put_str("s_county", np.asarray(_COUNTIES, dtype=object)[
            rng.integers(0, len(_COUNTIES), size=n)])
        put_str("s_state", np.asarray(_STATES, dtype=object)[
            rng.integers(0, len(_STATES), size=n)])
        put_str("s_zip", np.char.zfill(rng.integers(
            10000, 99999, size=n).astype(str), 5).astype(object))
        arrays["s_gmt_offset"] = np.full(n, -5.0)
        return _ht(name, n, arrays, dicts)

    if name == "warehouse":
        n = c["warehouse"]
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["w_warehouse_sk"] = sk
        put_str("w_warehouse_name", np.char.add("Warehouse ",
                sk.astype(str)).astype(object))
        arrays["w_warehouse_sq_ft"] = rng.integers(
            50000, 1000001, size=n).astype(np.int32)
        put_str("w_state", np.asarray(_STATES, dtype=object)[
            rng.integers(0, len(_STATES), size=n)])
        put_str("w_country", np.asarray(_COUNTRIES, dtype=object)[
            np.zeros(n, dtype=np.int64)])
        return _ht(name, n, arrays, dicts)

    if name == "promotion":
        n = c["promotion"]
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["p_promo_sk"] = sk
        put_str("p_promo_id", np.char.add("P", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        for col in ("p_channel_dmail", "p_channel_email", "p_channel_tv",
                    "p_channel_event"):
            put_str(col, np.where(rng.random(n) < 0.5, "Y", "N")
                    .astype(object))
        return _ht(name, n, arrays, dicts)

    if name == "customer_demographics":
        # cross product of (gender, marital, education, credit,
        # purchase_estimate) — a fixed dimension, as in the spec
        combos = [(g, m, e, cr, pe)
                  for g in ("M", "F") for m in _MARITAL
                  for e in _EDUCATION for cr in _CREDIT
                  for pe in range(500, 10001, 500)]
        n = len(combos)
        arrays["cd_demo_sk"] = np.arange(1, n + 1, dtype=np.int64)
        put_str("cd_gender", np.asarray([x[0] for x in combos],
                                        dtype=object))
        put_str("cd_marital_status", np.asarray([x[1] for x in combos],
                                                dtype=object))
        put_str("cd_education_status", np.asarray([x[2] for x in combos],
                                                  dtype=object))
        put_str("cd_credit_rating", np.asarray([x[3] for x in combos],
                                               dtype=object))
        arrays["cd_purchase_estimate"] = np.asarray(
            [x[4] for x in combos], dtype=np.int32)
        i = np.arange(n)
        arrays["cd_dep_count"] = (i % 7).astype(np.int32)
        arrays["cd_dep_employed_count"] = ((i // 7) % 7).astype(np.int32)
        arrays["cd_dep_college_count"] = ((i // 49) % 7).astype(np.int32)
        return _ht(name, n, arrays, dicts)

    if name == "household_demographics":
        combos = [(ib, bp, dep, veh)
                  for ib in range(1, 21) for bp in _BUY_POTENTIAL
                  for dep in range(0, 10) for veh in range(-1, 5)]
        n = len(combos)
        arrays["hd_demo_sk"] = np.arange(1, n + 1, dtype=np.int64)
        arrays["hd_income_band_sk"] = np.asarray(
            [x[0] for x in combos], dtype=np.int64)
        put_str("hd_buy_potential", np.asarray([x[1] for x in combos],
                                               dtype=object))
        arrays["hd_dep_count"] = np.asarray([x[2] for x in combos],
                                            dtype=np.int32)
        arrays["hd_vehicle_count"] = np.asarray([x[3] for x in combos],
                                                dtype=np.int32)
        return _ht(name, n, arrays, dicts)

    if name == "customer_address":
        n = c["customer_address"]
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["ca_address_sk"] = sk
        put_str("ca_address_id", np.char.add("A", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        put_str("ca_city", np.asarray(_CITIES, dtype=object)[
            rng.integers(0, len(_CITIES), size=n)])
        put_str("ca_county", np.asarray(_COUNTIES, dtype=object)[
            rng.integers(0, len(_COUNTIES), size=n)])
        put_str("ca_state", np.asarray(_STATES, dtype=object)[
            rng.integers(0, len(_STATES), size=n)])
        put_str("ca_zip", np.char.zfill(rng.integers(
            10000, 99999, size=n).astype(str), 5).astype(object))
        put_str("ca_country", np.asarray(_COUNTRIES, dtype=object)[
            np.zeros(n, dtype=np.int64)])
        arrays["ca_gmt_offset"] = rng.choice(
            [-5.0, -6.0, -7.0, -8.0], size=n)
        put_str("ca_location_type", np.asarray(
            ["apartment", "condo", "single family"], dtype=object)[
            rng.integers(0, 3, size=n)])
        return _ht(name, n, arrays, dicts)

    if name == "customer":
        n = c["customer"]
        ncd = _gen("customer_demographics", sf).num_rows
        nhd = _gen("household_demographics", sf).num_rows
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["c_customer_sk"] = sk
        put_str("c_customer_id", np.char.add("C", np.char.zfill(
            sk.astype(str), 15)).astype(object))
        arrays["c_current_cdemo_sk"] = rng.integers(
            1, ncd + 1, size=n).astype(np.int64)
        arrays["c_current_hdemo_sk"] = rng.integers(
            1, nhd + 1, size=n).astype(np.int64)
        arrays["c_current_addr_sk"] = rng.integers(
            1, c["customer_address"] + 1, size=n).astype(np.int64)
        put_str("c_salutation", np.asarray(
            ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"], dtype=object)[
            rng.integers(0, 6, size=n)])
        put_str("c_first_name", np.asarray(_FIRST, dtype=object)[
            rng.integers(0, len(_FIRST), size=n)])
        put_str("c_last_name", np.asarray(_LAST, dtype=object)[
            rng.integers(0, len(_LAST), size=n)])
        put_str("c_preferred_cust_flag",
                np.where(rng.random(n) < 0.5, "Y", "N").astype(object))
        arrays["c_birth_day"] = rng.integers(
            1, 29, size=n).astype(np.int32)
        arrays["c_birth_month"] = rng.integers(
            1, 13, size=n).astype(np.int32)
        arrays["c_birth_year"] = rng.integers(
            1924, 1993, size=n).astype(np.int32)
        put_str("c_birth_country", np.asarray(_COUNTRIES, dtype=object)[
            np.zeros(n, dtype=np.int64)])
        put_str("c_login", np.char.add("login", sk.astype(str))
                .astype(object))
        put_str("c_email_address", np.char.add(
            np.char.add("c", sk.astype(str)), "@example.com")
            .astype(object))
        arrays["c_last_review_date_sk"] = (
            _DATE_SK0 + (rng.integers(_SALES_D0, _SALES_D1 + 1, size=n)
                         - _D0)).astype(np.int64)
        return _ht(name, n, arrays, dicts)

    if name in ("store_sales", "catalog_sales", "web_sales"):
        return _gen_sales(name, sf)

    if name in ("store_returns", "catalog_returns", "web_returns"):
        return _gen_returns(name, sf)

    if name == "reason":
        descs = ["Package was damaged", "Stopped working",
                 "Did not get it on time", "Not the product ordered",
                 "Parts missing", "Does not work with a product bought",
                 "Gift exchange", "Did not like the color",
                 "Did not like the model", "Did not like the make",
                 "Found a better price", "Found a better extension",
                 "No service location", "Not working any more",
                 "Did not fit", "Wrong size", "Lost my job",
                 "unknown", "duplicate purchase", "its is a boy",
                 "its is a girl", "reason 22", "reason 23", "reason 24",
                 "reason 25", "reason 26", "reason 27", "reason 28",
                 "reason 29", "reason 30", "reason 31", "reason 32",
                 "reason 33", "reason 34", "reason 35"]
        n = len(descs)
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["r_reason_sk"] = sk
        put_str("r_reason_id", np.char.add("R", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        put_str("r_reason_desc", np.asarray(descs, dtype=object))
        return _ht(name, n, arrays, dicts)

    if name == "ship_mode":
        types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR",
                 "TWO DAY"]
        carriers = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS",
                    "ZHOU", "LATVIAN"]
        n = 20
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["sm_ship_mode_sk"] = sk
        put_str("sm_ship_mode_id", np.char.add("M", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        put_str("sm_type",
                np.asarray(types, dtype=object)[(sk - 1) % len(types)])
        put_str("sm_code", np.asarray(["AIR", "SURFACE", "SEA"],
                                      dtype=object)[(sk - 1) % 3])
        put_str("sm_carrier", np.asarray(carriers, dtype=object)[
            (sk - 1) % len(carriers)])
        return _ht(name, n, arrays, dicts)

    if name == "income_band":
        n = 20
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["ib_income_band_sk"] = sk
        arrays["ib_lower_bound"] = ((sk - 1) * 10000).astype(np.int32)
        arrays["ib_upper_bound"] = (sk * 10000).astype(np.int32)
        return _ht(name, n, arrays, dicts)

    if name == "web_page":
        n = 60
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["wp_web_page_sk"] = sk
        put_str("wp_web_page_id", np.char.add("P", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        put_str("wp_url", np.asarray(["http://www.foo.com"],
                                     dtype=object)[np.zeros(n, np.int64)])
        put_str("wp_type", np.asarray(
            ["general", "order", "feedback", "ad", "welcome",
             "protected", "dynamic"], dtype=object)[(sk - 1) % 7])
        arrays["wp_char_count"] = rng.integers(
            300, 8000, size=n).astype(np.int32)
        arrays["wp_link_count"] = rng.integers(
            2, 25, size=n).astype(np.int32)
        return _ht(name, n, arrays, dicts)

    if name == "web_site":
        names_ = ["site_0", "site_1", "site_2", "site_3"]
        n = 4 * 2
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["web_site_sk"] = sk
        put_str("web_site_id", np.char.add("W", np.char.zfill(
            sk.astype(str), 9)).astype(object))
        put_str("web_name", np.asarray(names_, dtype=object)[
            (sk - 1) % len(names_)])
        put_str("web_manager", np.asarray(_FIRST, dtype=object)[
            rng.integers(0, len(_FIRST), size=n)])
        put_str("web_company_name", np.asarray(["pri"], dtype=object)[
            np.zeros(n, np.int64)])
        arrays["web_gmt_offset"] = np.full(n, -5.0)
        return _ht(name, n, arrays, dicts)

    if name == "call_center":
        names_ = ["NY Metro", "Mid Atlantic", "Pacific Northwest",
                  "North Midwest", "California", "New England"]
        n = len(names_)
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["cc_call_center_sk"] = sk
        put_str("cc_call_center_id", np.char.add("CC", np.char.zfill(
            sk.astype(str), 8)).astype(object))
        put_str("cc_name", np.asarray(names_, dtype=object))
        put_str("cc_manager", np.asarray(_FIRST, dtype=object)[
            rng.integers(0, len(_FIRST), size=n)])
        put_str("cc_county", np.asarray(_COUNTIES, dtype=object)[
            rng.integers(0, len(_COUNTIES), size=n)])
        return _ht(name, n, arrays, dicts)

    if name == "catalog_page":
        n = 300
        sk = np.arange(1, n + 1, dtype=np.int64)
        arrays["cp_catalog_page_sk"] = sk
        put_str("cp_catalog_page_id", np.char.add("CP", np.char.zfill(
            sk.astype(str), 8)).astype(object))
        put_str("cp_department", np.asarray(["DEPARTMENT"],
                                            dtype=object)[
            np.zeros(n, np.int64)])
        put_str("cp_type", np.asarray(
            ["bi-annual", "quarterly", "monthly"], dtype=object)[
            (sk - 1) % 3])
        return _ht(name, n, arrays, dicts)

    if name == "inventory":
        # weekly snapshots over one year x items x warehouses (bounded)
        nit = min(c["item"], 400)
        nw = c["warehouse"]
        week_days = np.arange(_SALES_D0, _SALES_D0 + 364, 7,
                              dtype=np.int64)
        n = len(week_days) * nit * nw
        d = np.repeat(week_days, nit * nw)
        it = np.tile(np.repeat(np.arange(1, nit + 1, dtype=np.int64), nw),
                     len(week_days))
        wh = np.tile(np.arange(1, nw + 1, dtype=np.int64),
                     len(week_days) * nit)
        arrays["inv_date_sk"] = _DATE_SK0 + (d - _D0)
        arrays["inv_item_sk"] = it
        arrays["inv_warehouse_sk"] = wh
        q = rng.integers(0, 1001, size=n).astype(np.int32)
        arrays["inv_quantity_on_hand"] = q
        return _ht(name, n, arrays, dicts)

    raise KeyError(f"unknown tpcds table {name}")


_SALES_PREFIX = {"store_sales": "ss", "catalog_sales": "cs",
                 "web_sales": "ws"}

_RETURNS_OF = {"store_returns": "store_sales",
               "catalog_returns": "catalog_sales",
               "web_returns": "web_sales"}


@functools.lru_cache(maxsize=16)
def _gen_returns(name: str, sf: float) -> HostTable:
    """Returns facts derived from their sales tables (~9% return rate),
    so (ticket/order, item) join keys reference REAL sales rows — the
    spec's sales->returns lineage that q1/q17/q25/q94-style joins rely
    on."""
    sales = _gen_sales(_RETURNS_OF[name], sf)
    rng = np.random.default_rng(_seed(name, sf))
    n_sales = sales.num_rows
    mask = rng.random(n_sales) < 0.09
    idx = np.nonzero(mask)[0]
    n = len(idx)

    def scol(col):
        return sales.arrays[col][:n_sales][idx]

    def snull(col):
        m = (sales.nulls or {}).get(col)
        return None if m is None else m[:n_sales][idx]

    arrays: Dict[str, np.ndarray] = {}
    dicts: Dict[str, StringDict] = {}
    nulls: Dict[str, np.ndarray] = {}

    qty = scol({"store_returns": "ss_quantity",
                "catalog_returns": "cs_quantity",
                "web_returns": "ws_quantity"}[name])
    price = scol({"store_returns": "ss_sales_price",
                  "catalog_returns": "cs_sales_price",
                  "web_returns": "ws_sales_price"}[name])
    ret_qty = np.minimum(rng.integers(1, 101, size=n), qty).astype(
        np.int32)
    amt = np.round(price * ret_qty, 2)
    tax = np.round(amt * 0.05, 2)
    fee = np.round(rng.uniform(0.5, 100.0, size=n), 2)
    ship = np.round(amt * 0.12, 2)
    cash = np.round(amt * rng.uniform(0.0, 1.0, size=n), 2)
    reverse = np.round((amt - cash) * rng.uniform(0, 1, size=n), 2)
    credit = np.round(amt - cash - reverse, 2)
    loss = np.round(fee + ship + tax * 0.5, 2)
    n_reason = len(_gen("reason", sf).arrays["r_reason_sk"])
    reason = rng.integers(1, n_reason + 1, size=n).astype(np.int64)
    ret_time = rng.integers(0, 86400, size=n).astype(np.int64)

    def put(col, vals, null_src=None, null_rate=0.0):
        arrays[col] = vals
        m = snull(null_src) if null_src else None
        if null_rate > 0.0:
            extra = rng.random(n) < null_rate
            m = extra if m is None else (m | extra)
        if m is not None and m.any():
            nulls[col] = m

    if name == "store_returns":
        sold = scol("ss_sold_date_sk")
        put("sr_returned_date_sk",
            sold + rng.integers(1, 91, size=n), null_rate=0.01)
        put("sr_return_time_sk", ret_time)
        put("sr_item_sk", scol("ss_item_sk"))
        put("sr_customer_sk", scol("ss_customer_sk"),
            null_src="ss_customer_sk")
        put("sr_cdemo_sk", scol("ss_cdemo_sk"), null_src="ss_cdemo_sk")
        put("sr_hdemo_sk", scol("ss_hdemo_sk"), null_src="ss_hdemo_sk")
        put("sr_addr_sk", scol("ss_addr_sk"), null_src="ss_addr_sk")
        put("sr_store_sk", scol("ss_store_sk"), null_src="ss_store_sk")
        put("sr_reason_sk", reason, null_rate=0.02)
        put("sr_ticket_number", scol("ss_ticket_number"))
        put("sr_return_quantity", ret_qty)
        put("sr_return_amt", amt)
        put("sr_return_tax", tax)
        put("sr_return_amt_inc_tax", np.round(amt + tax, 2))
        put("sr_fee", fee)
        put("sr_return_ship_cost", ship)
        put("sr_refunded_cash", cash)
        put("sr_reversed_charge", reverse)
        put("sr_store_credit", credit)
        put("sr_net_loss", loss)
    elif name == "catalog_returns":
        sold = scol("cs_sold_date_sk")
        ncc = 6
        put("cr_returned_date_sk", sold + rng.integers(1, 91, size=n))
        put("cr_returned_time_sk", ret_time)
        put("cr_item_sk", scol("cs_item_sk"))
        put("cr_refunded_customer_sk", scol("cs_bill_customer_sk"),
            null_src="cs_bill_customer_sk")
        put("cr_returning_customer_sk", scol("cs_bill_customer_sk"),
            null_src="cs_bill_customer_sk")
        put("cr_returning_addr_sk", scol("cs_bill_addr_sk"),
            null_src="cs_bill_addr_sk")
        put("cr_call_center_sk",
            rng.integers(1, ncc + 1, size=n).astype(np.int64),
            null_rate=0.02)
        put("cr_catalog_page_sk",
            rng.integers(1, 301, size=n).astype(np.int64))
        put("cr_reason_sk", reason, null_rate=0.02)
        put("cr_order_number", scol("cs_order_number"))
        put("cr_return_quantity", ret_qty)
        put("cr_return_amount", amt)
        put("cr_return_tax", tax)
        put("cr_fee", fee)
        put("cr_return_ship_cost", ship)
        put("cr_refunded_cash", cash)
        put("cr_reversed_charge", reverse)
        put("cr_store_credit", credit)
        put("cr_net_loss", loss)
    else:
        sold = scol("ws_sold_date_sk")
        put("wr_returned_date_sk", sold + rng.integers(1, 91, size=n))
        put("wr_returned_time_sk", ret_time)
        put("wr_item_sk", scol("ws_item_sk"))
        put("wr_refunded_customer_sk", scol("ws_bill_customer_sk"),
            null_src="ws_bill_customer_sk")
        put("wr_refunded_cdemo_sk",
            rng.integers(1, _gen("customer_demographics", sf).num_rows
                         + 1, size=n).astype(np.int64), null_rate=0.02)
        put("wr_refunded_addr_sk", scol("ws_bill_addr_sk"),
            null_src="ws_bill_addr_sk")
        put("wr_returning_customer_sk", scol("ws_bill_customer_sk"),
            null_src="ws_bill_customer_sk")
        put("wr_returning_cdemo_sk",
            rng.integers(1, _gen("customer_demographics", sf).num_rows
                         + 1, size=n).astype(np.int64), null_rate=0.02)
        put("wr_returning_addr_sk", scol("ws_bill_addr_sk"),
            null_src="ws_bill_addr_sk")
        put("wr_web_page_sk",
            rng.integers(1, 61, size=n).astype(np.int64),
            null_rate=0.02)
        put("wr_reason_sk", reason, null_rate=0.02)
        put("wr_order_number", scol("ws_order_number"))
        put("wr_return_quantity", ret_qty)
        put("wr_return_amt", amt)
        put("wr_return_tax", tax)
        put("wr_fee", fee)
        put("wr_return_ship_cost", ship)
        put("wr_refunded_cash", cash)
        put("wr_reversed_charge", reverse)
        put("wr_account_credit", credit)
        put("wr_net_loss", loss)
    return _ht(name, n, arrays, dicts, nulls or None)


@functools.lru_cache(maxsize=16)
def _gen_sales(name: str, sf: float) -> HostTable:
    c = _counts(sf)
    rng = np.random.default_rng(_seed(name, sf))
    n = c[name]
    ncd = _gen("customer_demographics", sf).num_rows
    nhd = _gen("household_demographics", sf).num_rows
    nit = c["item"]

    days = rng.integers(_SALES_D0, _SALES_D1 + 1, size=n).astype(np.int64)
    date_sk = _DATE_SK0 + (days - _D0)
    time_sk = rng.integers(0, 86400, size=n).astype(np.int64)
    item = rng.integers(1, nit + 1, size=n).astype(np.int64)
    cust = rng.integers(1, c["customer"] + 1, size=n).astype(np.int64)
    cdemo = rng.integers(1, ncd + 1, size=n).astype(np.int64)
    hdemo = rng.integers(1, nhd + 1, size=n).astype(np.int64)
    addr = rng.integers(1, c["customer_address"] + 1,
                        size=n).astype(np.int64)
    promo = rng.integers(1, c["promotion"] + 1, size=n).astype(np.int64)
    qty = rng.integers(1, 101, size=n).astype(np.int32)
    wholesale = np.round(rng.uniform(1.0, 100.0, size=n), 2)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, size=n), 2)
    sales_price = np.round(list_price * rng.uniform(0.0, 1.0, size=n), 2)
    ext_discount = np.round((list_price - sales_price) * qty, 2)
    ext_sales = np.round(sales_price * qty, 2)
    ext_whole = np.round(wholesale * qty, 2)
    ext_list = np.round(list_price * qty, 2)
    coupon = np.where(rng.random(n) < 0.1,
                      np.round(ext_sales * rng.uniform(0, 0.5, size=n), 2),
                      0.0)
    net_paid = np.round(ext_sales - coupon, 2)
    net_profit = np.round(net_paid - ext_whole, 2)

    # Fact FK columns are NULLable in the spec data — carry REAL null
    # masks (queries like q44/q76 select on `fk IS NULL`).
    arrays: Dict[str, np.ndarray] = {}
    dicts: Dict[str, StringDict] = {}
    nulls: Dict[str, np.ndarray] = {}
    pre = _SALES_PREFIX[name]

    def put(col, vals, null_rate: float = 0.0):
        arrays[f"{pre}_{col}"] = vals
        if null_rate > 0.0:
            nulls[f"{pre}_{col}"] = rng.random(n) < null_rate

    put("sold_date_sk", date_sk)
    put("sold_time_sk", time_sk)
    ext_tax = np.round(ext_sales * 0.05, 2)
    if name == "store_sales":
        put("item_sk", item)
        put("customer_sk", cust, 0.01)
        put("cdemo_sk", cdemo, 0.04)
        put("hdemo_sk", hdemo, 0.04)
        put("addr_sk", addr, 0.01)
        put("store_sk", 1 + (item + cust) % _counts(sf)["store"], 0.01)
        put("promo_sk", promo, 0.04)
        put("ticket_number", np.arange(1, n + 1, dtype=np.int64))
        put("quantity", qty)
        put("wholesale_cost", wholesale)
        put("list_price", list_price)
        put("sales_price", sales_price)
        put("ext_discount_amt", ext_discount)
        put("ext_sales_price", ext_sales)
        put("ext_wholesale_cost", ext_whole)
        put("ext_list_price", ext_list)
        put("ext_tax", ext_tax)
        put("coupon_amt", coupon)
        put("net_paid", net_paid)
        put("net_profit", net_profit)
    elif name == "catalog_sales":
        put("ship_date_sk", date_sk + rng.integers(2, 91, size=n))
        put("bill_customer_sk", cust, 0.01)
        put("bill_cdemo_sk", cdemo, 0.04)
        put("bill_addr_sk", addr, 0.01)
        put("ship_addr_sk",
            rng.integers(1, c["customer_address"] + 1,
                         size=n).astype(np.int64), 0.01)
        put("ship_customer_sk",
            rng.integers(1, c["customer"] + 1,
                         size=n).astype(np.int64), 0.01)
        put("warehouse_sk",
            rng.integers(1, c["warehouse"] + 1,
                         size=n).astype(np.int64))
        put("ship_mode_sk",
            rng.integers(1, 21, size=n).astype(np.int64))
        put("call_center_sk",
            rng.integers(1, 7, size=n).astype(np.int64), 0.02)
        put("item_sk", item)
        put("promo_sk", promo, 0.04)
        # line items share orders (q16's multi-warehouse EXISTS shape)
        put("order_number", 1 + (np.arange(n, dtype=np.int64) // 3))
        put("quantity", qty)
        put("wholesale_cost", wholesale)
        put("list_price", list_price)
        put("sales_price", sales_price)
        put("ext_discount_amt", ext_discount)
        put("ext_sales_price", ext_sales)
        put("ext_wholesale_cost", ext_whole)
        put("ext_list_price", ext_list)
        put("ext_ship_cost", np.round(ext_list * 0.1, 2))
        put("coupon_amt", coupon)
        put("net_paid", net_paid)
        put("net_profit", net_profit)
    else:
        put("ship_date_sk", date_sk + rng.integers(1, 31, size=n))
        put("item_sk", item)
        put("bill_customer_sk", cust, 0.01)
        put("ship_customer_sk",
            rng.integers(1, c["customer"] + 1,
                         size=n).astype(np.int64), 0.01)
        put("bill_addr_sk", addr, 0.01)
        put("ship_addr_sk",
            rng.integers(1, c["customer_address"] + 1,
                         size=n).astype(np.int64), 0.01)
        put("warehouse_sk",
            rng.integers(1, c["warehouse"] + 1,
                         size=n).astype(np.int64))
        put("ship_mode_sk",
            rng.integers(1, 21, size=n).astype(np.int64))
        put("ship_hdemo_sk", hdemo, 0.04)
        put("web_page_sk",
            rng.integers(1, 61, size=n).astype(np.int64), 0.02)
        put("web_site_sk", 1 + item % 4)
        put("promo_sk", promo, 0.04)
        # several line items share one order (q94/q95 multi-warehouse
        # EXISTS shapes need real order groups)
        put("order_number",
            1 + (np.arange(n, dtype=np.int64) // 3))
        put("quantity", qty)
        put("wholesale_cost", wholesale)
        put("list_price", list_price)
        put("sales_price", sales_price)
        put("ext_discount_amt", ext_discount)
        put("ext_sales_price", ext_sales)
        put("ext_list_price", ext_list)
        put("ext_wholesale_cost", ext_whole)
        put("ext_ship_cost", np.round(ext_list * 0.1, 2))
        put("net_paid", net_paid)
        put("net_profit", net_profit)

    return _ht(name, n, arrays, dicts, nulls or None)


from presto_tpu_torch.connectors.base import SplitSource


class TpcdsConnector(SplitSource):
    NAME = "tpcds"
    """Second fixture connector (reference: presto-tpcds). Same surface as
    TpchConnector: schema / row_count / partitioned table slices sharing
    one table-wide StringDict per string column."""

    def __init__(self, scale_factor: float = 0.01):
        self.scale_factor = scale_factor

    def schema(self, table: str) -> List[Tuple[str, Type]]:
        return TPCDS_SCHEMA[table]

    def row_count(self, table: str) -> int:
        if table == "date_dim":
            return _N_DATES
        if table == "time_dim":
            return 86400
        if table in _counts(self.scale_factor):
            return _counts(self.scale_factor)[table]
        return _gen(table, self.scale_factor).num_rows

    def table(self, name: str, part: int = 0, num_parts: int = 1
              ) -> HostTable:
        if name not in TPCDS_SCHEMA:
            raise KeyError(f"unknown tpcds table {name}")
        full = _gen(name, self.scale_factor)
        if num_parts == 1:
            return full
        lo, hi = _slice_rows(full.num_rows, part, num_parts)
        arrays = {c: a[lo:hi] for c, a in full.arrays.items()}
        nulls = ({c: m[lo:hi] for c, m in full.nulls.items()}
                 if full.nulls is not None else None)
        return HostTable(name, hi - lo, arrays, full.types, full.dicts,
                         nulls)
