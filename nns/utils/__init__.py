from nns.utils.timing import Timer, now_ns, time_callable, warmup  # noqa: F401
from nns.utils.report import RunRecord, ReportWriter, format_table  # noqa: F401
from nns.utils.profiling import (  # noqa: F401
    DeviceOpReport,
    parse_xplane,
    profile_device_ops,
)
