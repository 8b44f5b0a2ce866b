"""The reference's examples on the port, each run as
``python -m repro_torch.examples.<name> [--device cpu]``.

Each builds a pilot with a world of rank processes
(``PilotDescription(ranks=4)``), so its ``spmd`` bodies run on every rank
of their slot block and reduce with the port's collectives
(``repro_torch.core.shard_map``/``psum``/``pmean``).  Without
``--device cpu`` they run on the card, and raise without one.
"""
