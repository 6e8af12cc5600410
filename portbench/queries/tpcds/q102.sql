-- the shape of TPC-DS query 70 (stores ranked by profit within a state):
-- rank() over an aggregate, the top 3 of each partition, as
-- tests/test_torch_tpcds.py holds it (w_ds_rank_stores)
SELECT * FROM (
  SELECT s_state, s_store_name, i_category, sum(ss_net_profit) AS profit,
         rank() OVER (PARTITION BY s_state ORDER BY sum(ss_net_profit) DESC) AS rk
  FROM tpcds.{s}.store_sales, tpcds.{s}.store, tpcds.{s}.item
  WHERE ss_store_sk = s_store_sk AND ss_item_sk = i_item_sk
  GROUP BY s_state, s_store_name, i_category) t
WHERE rk <= 3 ORDER BY s_state, rk, s_store_name, i_category
