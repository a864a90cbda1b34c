"""Pure tensor ops: n-step returns, exploration, losses, the replay sampler."""
