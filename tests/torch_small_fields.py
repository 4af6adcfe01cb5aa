"""The prime fields below 253 bits that the port's tests run on, as the
port's ``PrimeField`` (the package ships only the reference's three
255-bit fields). Public moduli:

* Goldilocks, 2^64 − 2^32 + 1 (64 bits): Plonky2's and Polygon's field;
* the Mersenne prime 2^127 − 1;
* NIST P-192's prime, 2^192 − 2^64 − 1;
* Jubjub's scalar field (252 bits), the order of the Sapling embedded
  curve's prime subgroup: in the 250-252-bit window where the semi routes
  and ``mulcmp`` apply but the 16-bit pipeline's quotient estimate does
  not."""

from bellpepper_tpu_torch.fields import PrimeField

GOLDILOCKS_P = 2**64 - 2**32 + 1
M127_P = 2**127 - 1
P192_P = 2**192 - 2**64 - 1
JUBJUB_FR_P = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7

GOLDILOCKS = PrimeField("goldilocks", GOLDILOCKS_P)
M127 = PrimeField("m127", M127_P)
P192 = PrimeField("p192", P192_P)
JUBJUB_FR = PrimeField("jubjub_fr", JUBJUB_FR_P)
SMALL_FIELDS = [GOLDILOCKS, M127, P192, JUBJUB_FR]
