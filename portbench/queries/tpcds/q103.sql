-- the shape of TPC-DS queries 5 and 77 (profit by sales channel): UNION ALL
-- of the three channels' sales, as tests/test_torch_tpcds.py holds it
-- (s_ds_channels)
SELECT channel, count(*) AS n, sum(profit) AS profit
FROM (SELECT 'store' AS channel, ss_net_profit AS profit, ss_sold_date_sk AS dk
      FROM tpcds.{s}.store_sales
      UNION ALL SELECT 'web', ws_net_profit, ws_sold_date_sk FROM tpcds.{s}.web_sales
      UNION ALL SELECT 'catalog', cs_ext_list_price, cs_sold_date_sk
      FROM tpcds.{s}.catalog_sales) x,
     tpcds.{s}.date_dim
WHERE dk = d_date_sk AND d_year = 2000 GROUP BY channel ORDER BY channel
