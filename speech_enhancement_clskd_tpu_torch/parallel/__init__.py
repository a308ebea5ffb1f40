"""Data parallelism over a process group and sequence parallelism for long
utterances (``distributed``, ``mesh``, ``sequence``)."""
