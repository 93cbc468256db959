"""Small helpers shared by the ops: device resolution and call metrics."""
