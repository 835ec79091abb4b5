from .cache_store import SCHEMA_VERSION, CacheStore  # noqa: F401
from .coalesce import BadRequest, OptRequest, group_requests  # noqa: F401
from .engine import ServeEngine  # noqa: F401
from .optserver import OptServer, ServerOverloaded  # noqa: F401
