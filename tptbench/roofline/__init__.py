"""The yardstick of the casts' roofline share: the H100's published
peaks and the least work that the sweep casts' results need."""
