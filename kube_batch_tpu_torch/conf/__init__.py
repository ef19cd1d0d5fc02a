from .scheduler_conf import (
    DEFAULT_SCHEDULER_CONF,
    PluginOption,
    SchedulerConfiguration,
    Tier,
    apply_plugin_conf_defaults,
    parse_scheduler_conf,
)
