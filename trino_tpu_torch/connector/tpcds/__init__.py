from trino_tpu_torch.connector.tpcds.connector import TpcdsConnector  # noqa: F401
