"""The port's service layer (``lakesoul_tpu/service/``): HS256 tokens,
domain RBAC, data-asset statistics, the Arrow Flight gateway and the Flight
SQL server on top of it, the RBAC storage proxy with its S3 and Azure
upstreams, and the console.  Wire formats are the reference's, so a client of
either package talks to a server of either package."""

from lakesoul_tpu_torch.service.jwt import JwtServer
from lakesoul_tpu_torch.service.rbac import RbacVerifier

__all__ = ["JwtServer", "RbacVerifier", "LakeSoulFlightServer", "LakeSoulFlightClient",
           "LakeSoulFlightSqlServer", "FlightSqlClient"]


def __getattr__(name):
    # pyarrow.flight imports are deferred: metadata/RBAC users shouldn't pay
    # for (or require) the Flight stack
    if name in ("LakeSoulFlightSqlServer", "FlightSqlClient"):
        from lakesoul_tpu_torch.service import flight_sql

        return getattr(flight_sql, name)
    if name in ("LakeSoulFlightServer", "LakeSoulFlightClient"):
        from lakesoul_tpu_torch.service import flight

        return getattr(flight, name)
    raise AttributeError(name)
