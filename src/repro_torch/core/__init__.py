"""Cohmeleon core: modes, Table-3 state, rewards, Q-learning, policies."""
