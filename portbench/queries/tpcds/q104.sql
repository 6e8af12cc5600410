-- items sold in any channel: UNION (DISTINCT) of the three channels' items,
-- as tests/test_torch_tpcds.py holds it (s_ds_union_distinct)
SELECT count(*) FROM (SELECT ss_item_sk AS item FROM tpcds.{s}.store_sales
                      UNION SELECT ws_item_sk FROM tpcds.{s}.web_sales
                      UNION SELECT cs_item_sk FROM tpcds.{s}.catalog_sales) u
