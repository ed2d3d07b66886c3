"""Host-side utilities of the port (``twixt_for_open_spiel_tpu/utils``).

  serialization.py  training checkpoints: ``save_training``,
                    ``restore_training``

The history-replay and pytree halves of the JAX module wait for the host
adapter (``ROADMAP.md`` Queue 1, item 7).
"""
