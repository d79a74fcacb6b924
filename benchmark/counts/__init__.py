"""The yardstick's counting: published peaks of the card, and the
operations and bytes that the inputs of each model family and each kernel
need, computed from shapes."""
