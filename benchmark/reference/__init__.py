"""The benchmark's plain reference of the fleet frame (see ``steps``)."""
