"""Curve constants for MNT4753 and MNT6753: the benchmark's frozen copy of
the port's curves/constants.py, so the reference shares no code with the
program under test.

Values transcribed from the reference implementation's curve-initialisation
files:
  depends/libff/libff/algebra/curves/mnt753/mnt4753/mnt4753_init.cpp:40-263
  depends/libff/libff/algebra/curves/mnt753/mnt6753/mnt6753_init.cpp:42-260

The two curves form a 2-cycle: MNT4753's Fq equals MNT6753's Fr and vice
versa (mnt4753_init.cpp:48,75 vs mnt6753_init.cpp:50,79).

All big integers are plain Python ints (exact arbitrary precision).  The
serialized file format of the reference stores field elements as 12 x u64
little-endian limbs of the Montgomery representation x*R mod p with
R = 2^768 (libsnark/serialization.hpp:22-32).
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

# Montgomery radix used by the reference file format (12 x 64-bit limbs).
LIMB_BITS = 64
NUM_LIMBS = 12
R_BITS = LIMB_BITS * NUM_LIMBS  # 768
R = 1 << R_BITS

# ---------------------------------------------------------------------------
# The two 753-bit primes of the MNT4753/MNT6753 cycle.
#   P_A = MNT4753 r = MNT6753 q   (two-adicity 30)
#   P_B = MNT4753 q = MNT6753 r   (two-adicity 15, small 5^2 subgroup on the
#                                  MNT6753-Fr view)
# mnt4753_init.cpp:48 / mnt6753_init.cpp:79 and mnt4753_init.cpp:75 /
# mnt6753_init.cpp:50.
# ---------------------------------------------------------------------------
P_A = int(
    "4189849096791895340234421479124063712817070991995394907178350292102535281"
    "2571106773058893763790338921418070971888458477323173057491593855069696241"
    "8547963961657214163253500644414704181378463984696119357190599081642207844"
    "76160001"
)
P_B = int(
    "4189849096791895340234421479124063712817070991995394907178350292102535281"
    "2571106773058893763790338921418070971888253786114353726529584385201591605"
    "7220131264689314043479498405430079863277434628537206280516921412653031147"
    "21689601"
)

assert P_A.bit_length() == 753 and P_B.bit_length() == 753


@dataclass(frozen=True)
class FieldParams:
    """Parameters of one prime field (libff Fp_model equivalents)."""

    p: int
    s: int                      # two-adicity: p - 1 = t * 2^s, t odd
    t: int
    multiplicative_generator: int
    root_of_unity: int          # generator of the order-2^s subgroup
    nqr: int
    # MNT6753 Fr defines a small 5^2 subgroup (mnt6753_init.cpp:73-76).
    small_subgroup_base: Optional[int] = None
    small_subgroup_power: Optional[int] = None
    full_root_of_unity: Optional[int] = None


FIELD_A = FieldParams(
    p=P_A,
    s=30,
    t=(P_A - 1) >> 30,
    multiplicative_generator=17,
    root_of_unity=int(
        "5431548564651772770863376209190533321743766006080874345421017090576169"
        "9203047139500946280436927728019954715398494115227044713939878828833556"
        "24697206026582300050878644000631322086989454860102191886653186986980927"
        "065212650747291"
    ),
    nqr=11,
)

# Field "B": modulus P_B. Used as MNT4753.Fq and MNT6753.Fr.
# Constants from mnt4753_init.cpp:75-98 (Fq view) and mnt6753_init.cpp:50-76
# (Fr view, which adds the small 5^2 subgroup data).
FIELD_B = FieldParams(
    p=P_B,
    s=15,
    t=(P_B - 1) >> 15,
    multiplicative_generator=17,
    root_of_unity=int(
        "4057782239841298271987667181434762231172587855940010056522122386022639"
        "6934830112376659822430317692232440883010225033880793828874730711721234"
        "32569424046085574176379154047470615017037409055069542780658323630193015"
        "7866709353840964"
    ),
    nqr=13,
    small_subgroup_base=5,
    small_subgroup_power=2,
    full_root_of_unity=int(
        "1224945890276221774762683291971092661851001145536496372639375285464991"
        "4979954138109976331601455448780251166045203053508523342111624583986869"
        "30165836662535682688878569182371059847077545374213359363452461942962980"
        "3955083254436531"
    ),
)

# Sanity: root_of_unity has exact order 2^s; full root has order 2^s * 5^2.
assert pow(FIELD_A.root_of_unity, 1 << 30, P_A) == 1
assert pow(FIELD_A.root_of_unity, 1 << 29, P_A) != 1
assert pow(FIELD_B.root_of_unity, 1 << 15, P_B) == 1
assert pow(FIELD_B.full_root_of_unity, (1 << 15) * 25, P_B) == 1


@dataclass(frozen=True)
class CurveParams:
    """One curve of the cycle (libff mnt{4,6}753_pp equivalents).

    G2 lives on a twist over Fq^deg with the given non-residue; twist
    coefficients are stored as tuples of Fq ints (coefficient vectors of the
    extension element, constant term first) matching mnt4753_init.cpp:118-131
    / mnt6753_init.cpp:129-147.
    """

    name: str
    fq: FieldParams
    fr: FieldParams
    a: int                       # G1 short-Weierstrass coefficient a
    b: int                       # G1 coefficient b
    ext_degree: int              # 2 for MNT4753 (Fq2), 3 for MNT6753 (Fq3)
    non_residue: int             # alpha: Fq^deg = Fq[v]/(v^deg - alpha)
    twist_a: Tuple[int, ...]     # G2 curve coefficient a (Fqe coeff vector)
    twist_b: Tuple[int, ...]     # G2 curve coefficient b
    g1_one: Tuple[int, int]      # affine generator of G1
    g2_one: Tuple[Tuple[int, ...], Tuple[int, ...]]  # affine generator of G2


MNT4753_B = int(
    "2879880390345638889141003679329940576494037236009993834075257640639388037"
    "2126970068421383312482853541572780087363938442377933706865252053507077543"
    "4205343804864927866265562690832556571250259638256108402225686941371387415"
    "54679540"
)

MNT6753_B = int(
    "1162590899954132115202734022401037471684116770178358464833890823541085926"
    "7060079819722747939267925389062611062156601938166010098747920378738927832"
    "6581336254542601154090758161875550558594902533757047280279443155011227234"
    "26879114"
)

MNT4753 = CurveParams(
    name="MNT4753",
    fq=FIELD_B,
    fr=FIELD_A,
    a=2,
    b=MNT4753_B,
    ext_degree=2,
    non_residue=13,
    # twist_coeff_a = (a * 13, 0); twist_coeff_b = (0, b * 13)
    # (mnt4753_init.cpp:122-123)
    twist_a=(2 * 13, 0),
    twist_b=(0, (MNT4753_B * 13) % P_B),
    g1_one=(
        int(
            "2380350383848269736421921239610031425526628225628775853221046095867"
            "0711284501374254909249084643549104668878996224193897061976788052185"
            "6625697387740287564466624009548176769473370906862571348747032241331"
            "83061214213216866019444443"
        ),
        int(
            "2109101215293822581305054066528029192903292433351847627911071114867"
            "0464794818544820522390295209715531901248676888544060590943737249563"
            "7331048066979687797966103749944987026988401695387251649560727269425"
            "00665132927942037078135054"
        ),
    ),
    g2_one=(
        (
            int(
                "2236766662332108072006025684467936984145084925863448512222682666868"
                "7008928557241162389052587294939105987791589807198701072089850184203"
                "0606290360900272068845473978190800269264122569781355367356560491730"
                "59573120822105654153939204"
            ),
            int(
                "1967434935406558266356988639055710521537576435646401391080413653483"
                "1880915742161945711267871023918136941472003751075703860943205026648"
                "8470642470801246707991909983952346941826217945801605768221672281874"
                "43851233972049521455293042"
            ),
        ),
        (
            int(
                "6945425020677398967988875731588951175743495235863391886533295045397"
                "0376053265353306573617717659031754810627593674989707430228724945464"
                "4943681584330683879472931305099868115900057942773302970998707325473"
                "3976366326071957733646574"
            ),
            int(
                "1740610077548935273867848515402703619161828316367998019519367789678"
                "5273172506466216232026037788788436442188057889820014276378772936042"
                "6387177103849872394309123646810460706252004749319752668759952820554"
                "99803236813013874788622488"
            ),
        ),
    ),
)

MNT6753 = CurveParams(
    name="MNT6753",
    fq=FIELD_A,
    fr=FIELD_B,
    a=11,
    b=MNT6753_B,
    ext_degree=3,
    non_residue=11,
    # twist_coeff_a = (0, 0, a); twist_coeff_b = (b * 11, 0, 0)
    # (mnt6753_init.cpp:133-136)
    twist_a=(0, 0, 11),
    twist_b=((MNT6753_B * 11) % P_A, 0, 0),
    g1_one=(
        int(
            "1636423638749168944475905794433417357907074747373833974909348733764"
            "4739228935268157504218078126401066954815152892688541654726829424326"
            "5990385225035173024662261437889882174108426728575646655278060442500"
            "03808514184274233938437290"
        ),
        int(
            "4510127914410645922431074687553594593336087066778984214797709122300"
            "2109660769799272851619502030378013926245825440987506675491885497610"
            "3265470683022574399806433090030134656640850139063827332246717374162"
            "9353517809979540986561128"
        ),
    ),
    g2_one=(
        (
            int(
                "4653829723800628043404587933534938322121078948844112607364089523902"
                "3832290080310125413049878152095926176013036314720850781686614265244"
                "307536450228450615346834324267478485994670716807428718518299710702"
                "671895190475661871557310"
            ),
            int(
                "1032973993542701656456184296355188344591570142421417778291112876523"
                "0271790215029185795830999583638744119368571742929964793955375930677"
                "1785448734243929108840249863480591374493895337448516910821592330654"
                "44766899262771358355816328"
            ),
            int(
                "1996281705817433469186401523206267173635375622148589603407281426189"
                "4530786568591431279230352444205682361463997175937973249929732063490"
                "2568131017145861996425713443780122103743277640595578166479803347335"
                "38226843692316285591005879"
            ),
        ),
        (
            int(
                "5648166377754359996653513138027891970842739892107427747585228022871"
                "1095856800762406240134116229701099111541133787035628038270533350408"
                "7761893477371202144110112129769138963215590618265625414536866885436"
                "0318258860716497525179898"
            ),
            int(
                "2681785035602504563047731382887580889399493526586328091820794041261"
                "7168254772789578700316551065949899971937475487458539503514034928974"
                "5304320097595629759830773559120506065091479049582293983890936974941"
                "74311832813615564256810453"
            ),
            int(
                "3233231970935857844169673158670449558179685896259470163393292735804"
                "0566210788542624963749336109940335257143899293177116050031684054348"
                "9588132907813941312846571655404768242112955084988421020932198086425"
                "63477603392470909217611033"
            ),
        ),
    ),
)

CURVES = {"MNT4753": MNT4753, "MNT6753": MNT6753}


def get_root_of_unity(fp: FieldParams, n: int) -> int:
    """Domain generator for an order-n multiplicative subgroup.

    Mirrors libff::get_root_of_unity (field_utils.tcc:40-89) including the
    small-subgroup branch used by MNT6753 Fr: for n = 2^a * q^b the root is
    derived from full_root_of_unity by removing the excess q-part and
    2-part.
    """
    p = fp.p
    if fp.small_subgroup_base is not None:
        q = fp.small_subgroup_base
        q_adicity = 0
        nn = n
        while nn % q == 0:
            nn //= q
            q_adicity += 1
        two_adicity = 0
        while nn % 2 == 0:
            nn //= 2
            two_adicity += 1
        if nn != 1 or two_adicity > fp.s or q_adicity > fp.small_subgroup_power:
            raise ValueError(f"no root of unity of order {n}")
        omega = fp.full_root_of_unity
        for _ in range(fp.small_subgroup_power, q_adicity, -1):
            omega = pow(omega, q, p)
        for _ in range(fp.s, two_adicity, -1):
            omega = (omega * omega) % p
        return omega
    logn = n.bit_length() - 1
    if n != (1 << logn) or logn > fp.s:
        raise ValueError(f"no root of unity of order {n}")
    omega = fp.root_of_unity
    for _ in range(fp.s, logn, -1):
        omega = (omega * omega) % p
    return omega
