"""Port of ``x_multi_agent_tpu.parallel`` (payloads and the full-map exchange round)."""
