"""The SQL layer of the port (a copy of ``lakesoul_tpu/sql``): the parser
(``parse``, ``parse_predicate``, which ``scan.filter("...")`` uses), the
executor's ``SqlSession`` and the TPC-H-lite harness (``sql.tpch``)."""

from lakesoul_tpu_torch.sql.executor import SqlSession

__all__ = ["SqlSession"]
