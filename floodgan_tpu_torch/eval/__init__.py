"""The metric suite of the port: image metrics, mask metrics and LPIPS."""
