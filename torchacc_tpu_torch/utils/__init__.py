"""Logger and metrics helpers of the port."""
