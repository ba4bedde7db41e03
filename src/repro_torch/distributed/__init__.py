"""Fault tolerance: the training Runner (checkpoint-restart) and the
straggler policy it shares with the replicated serve tier."""
