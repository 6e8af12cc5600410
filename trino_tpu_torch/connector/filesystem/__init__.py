from trino_tpu_torch.connector.filesystem.connector import FileSystemConnector

__all__ = ["FileSystemConnector"]
