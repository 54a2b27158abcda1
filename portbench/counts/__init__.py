"""Operations and bytes, from shapes alone: what a model step and the
attention need, whatever implements them. The MFU and roofline readers
divide these by measured time."""
