"""The port's launchers: the LM train step and the trainer."""
