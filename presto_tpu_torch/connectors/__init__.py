from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpcds import TPCDS_SCHEMA, TpcdsConnector
from presto_tpu_torch.connectors.tpch import TPCH_SCHEMA, TpchConnector

__all__ = ["MemoryConnector", "TPCDS_SCHEMA", "TPCH_SCHEMA",
           "TpcdsConnector", "TpchConnector"]
