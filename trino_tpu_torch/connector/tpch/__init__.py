from trino_tpu_torch.connector.tpch.connector import TpchConnector

__all__ = ["TpchConnector"]
