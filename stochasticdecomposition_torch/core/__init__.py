"""SD algorithm pieces: state, stochastic updates, cuts, master, stopping, step."""
