"""The yardstick's arithmetic: the card's data-sheet peaks, the least time
of each hand-written kernel's work on a call's own inputs, and the model's
FLOPs counted on the plain reference."""
