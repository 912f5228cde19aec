"""The Flight gateway of the port (``lakesoul_tpu/service/``'s gateway half):
HS256 tokens, domain RBAC, data-asset statistics and the Arrow Flight
server / client whose wire format is the reference's, so a client of either
package talks to a gateway of either package.  The Flight SQL server and the
storage proxy are not ported yet."""

from lakesoul_tpu_torch.service.jwt import JwtServer
from lakesoul_tpu_torch.service.rbac import RbacVerifier

__all__ = ["JwtServer", "RbacVerifier", "LakeSoulFlightServer", "LakeSoulFlightClient"]


def __getattr__(name):
    # pyarrow.flight imports are deferred: metadata/RBAC users shouldn't pay
    # for (or require) the Flight stack
    if name in ("LakeSoulFlightSqlServer", "FlightSqlClient"):
        from lakesoul_tpu_torch.errors import ConfigError

        raise ConfigError(f"{name} (service/flight_sql.py) is not ported yet")
    if name in ("LakeSoulFlightServer", "LakeSoulFlightClient"):
        from lakesoul_tpu_torch.service import flight

        return getattr(flight, name)
    raise AttributeError(name)
