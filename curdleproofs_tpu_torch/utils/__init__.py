"""Helpers shared by the ops and the protocol: device resolution, call
metrics, the native host library, the lockstep batch prover, the proof
randomness, byte serde and the error types."""
