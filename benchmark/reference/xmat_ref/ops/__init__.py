"""Port of ``x_multi_agent_tpu.ops``."""
