from trino_tpu_torch.connector.blackhole.connector import BlackHoleConnector

__all__ = ["BlackHoleConnector"]
