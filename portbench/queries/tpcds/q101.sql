-- the shape of TPC-DS query 98 (revenue share of each item in its
-- category): a window sum over an aggregate, as tests/test_torch_tpcds.py
-- holds it (w_ds_revenue_share); not the q98 template, whose columns the
-- generator lacks
SELECT i_category, i_item_id, sum(ss_list_price * ss_quantity) AS revenue,
       sum(ss_list_price * ss_quantity) * 100
         / sum(sum(ss_list_price * ss_quantity)) OVER (PARTITION BY i_category) AS ratio
FROM tpcds.{s}.store_sales, tpcds.{s}.item, tpcds.{s}.date_dim
WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk AND d_year = 2000
  AND i_category IN ('Sports', 'Books', 'Home')
GROUP BY i_category, i_item_id
ORDER BY i_category, revenue DESC, i_item_id
LIMIT 100
