"""Example programs of the port (``twixt_for_open_spiel_tpu/examples``):
``selfplay_train.py``, the distributed self-play training front door."""
