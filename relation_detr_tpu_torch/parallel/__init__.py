"""Train step of the port."""
