"""Wave-batched serving engine over the port's LM."""
