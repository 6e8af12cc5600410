from trino_tpu_torch.connector.system.connector import (  # noqa: F401
    SYSTEM_CATALOG, SYSTEM_PROCEDURES, SYSTEM_TABLES, SystemConnector,
    metric_sample_rows)
