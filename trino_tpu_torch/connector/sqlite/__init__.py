from trino_tpu_torch.connector.sqlite.connector import SqliteConnector  # noqa: F401
