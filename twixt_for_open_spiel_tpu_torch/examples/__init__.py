"""Example programs of the port (``twixt_for_open_spiel_tpu/examples``):
``example.py`` (one random game through ``load_game``), ``mcts_example.py``
(MCTS or random bots), ``arena.py`` (two checkpoints, or one against the
random bot) and ``selfplay_train.py``, the distributed self-play training
front door.  Each runs on the card unless given ``--cpu``."""
