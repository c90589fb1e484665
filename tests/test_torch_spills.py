"""`tpusched_torch.spills`: the local loads and stores of a disassembly
counted by the source line they come from and the lines it was inlined
at (no toolkit needed: the text is given)."""

from tpusched_torch.spills import local_sites

SASS = """\
\t.section\t.text._Z9k_preemptPf,"ax",@progbits
.text._Z9k_preemptPf:
        /*0000*/                   MOV R1, c[0x0][0x28] ;
\t//## File "/src/csrc/preempt.cuh", line 220 inlined at "/src/csrc/scan.cu", line 470
        /*0010*/                   STL [R1+0x8], R4 ;
        /*0020*/                   STL.64 [R1+0x10], R6 ;
\t//## File "/src/csrc/scan.cu", line 480
        /*0030*/                   LDL.LU R4, [R1+0x8] ;
.text._Z5otherPf:
        /*0000*/                   STL [R1], R2 ;
"""


def test_local_sites_by_inlined_line():
    got = local_sites(SASS, "preempt")
    assert got == {"_Z9k_preemptPf": {"STL": {
        "preempt.cuh:220 < scan.cu:470": 2},
                                      "LDL": {"scan.cu:480": 1}}}
    assert set(local_sites(SASS)) == {"_Z9k_preemptPf", "_Z5otherPf"}
