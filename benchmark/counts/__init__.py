"""Operations and bytes of the benchmark's work, from shapes alone, and
the chip's published peaks they are held against."""
