"""The upscaler slots: the FSR-style temporal accumulator, the XeSS-slot
accumulator and the learned CNN of the DLSS slot."""
